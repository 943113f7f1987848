"""PyTorch port: the host data pipeline against the JAX package's.

On-disk fixtures built as tests/test_data.py builds them (no downloads):
the datasets, collate_matchinput, the loader, sampler, sharding and
augmentors of ``loftr_tpu_torch.data`` give arrays equal to those of
``loftr_tpu.data``; make_synthetic_megadepth writes the same files for
the same seed.
"""
import os
import sys

import cv2
import h5py
import numpy as np
import pytest
import torch

import loftr_tpu.data as jd
from loftr_tpu.data import augment as jaug
from loftr_tpu.data import megadepth as jmd
from loftr_tpu.data import sampler as jsamp
from loftr_tpu.data import synthetic as jsyn
import loftr_tpu_torch.data as td
from loftr_tpu_torch.data import augment as taug
from loftr_tpu_torch.data import megadepth as tmd
from loftr_tpu_torch.data import sampler as tsamp
from loftr_tpu_torch.data import synthetic as tsyn
from loftr_tpu_torch.structs import MatchInput


@pytest.fixture(scope="module")
def scannet_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("scannet")
    scene = "scene0000_00"
    for sub in ("color", "depth", "pose"):
        os.makedirs(root / scene / sub)
    rng = np.random.RandomState(0)
    for stem in (0, 15, 30):
        img = rng.randint(0, 255, (480, 640), np.uint8)
        cv2.imwrite(str(root / scene / "color" / f"{stem}.jpg"), img)
        depth = rng.randint(500, 3000, (480, 640)).astype(np.uint16)
        cv2.imwrite(str(root / scene / "depth" / f"{stem}.png"), depth)
        pose = np.eye(4)
        pose[:3, 3] = rng.rand(3)
        np.savetxt(str(root / scene / "pose" / f"{stem}.txt"), pose,
                   delimiter=" ")
    np.savez(str(root / "intrinsics.npz"),
             **{scene: np.array([[500.0, 0, 320], [0, 500.0, 240],
                                 [0, 0, 1]])})
    np.savez(str(root / "pairs.npz"),
             name=np.array([[0, 0, 0, 15], [0, 0, 15, 30]], np.uint16),
             score=np.array([0.6, 0.5]))
    T = np.eye(4)
    T[:3, 3] = [1.0, 2.0, 3.0]
    np.savez(str(root / "test.npz"),
             name=np.array([[0, 0, 0, 15]], np.uint16),
             rel_pose=np.array([T[:3].reshape(-1)]))
    return root


@pytest.fixture(scope="module")
def megadepth_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("megadepth")
    os.makedirs(root / "imgs")
    os.makedirs(root / "depths")
    rng = np.random.RandomState(1)
    image_paths, depth_paths, intrinsics, poses = [], [], [], []
    for i, (h, w) in enumerate([(480, 640), (600, 800), (512, 384)]):
        p = f"imgs/im{i}.jpg"
        cv2.imwrite(str(root / p), rng.randint(0, 255, (h, w), np.uint8))
        dp = f"depths/d{i}.h5"
        with h5py.File(str(root / dp), "w") as f:
            f["depth"] = rng.rand(h, w).astype(np.float32) * 5
        image_paths.append(p)
        depth_paths.append(dp)
        intrinsics.append(np.array([[400.0, 0, w / 2], [0, 400.0, h / 2],
                                    [0, 0, 1]]))
        T = np.eye(4)
        T[:3, 3] = rng.rand(3)
        poses.append(T)
    pair_infos = np.array(
        [((0, 1), 0.5, None), ((1, 2), 0.7, None), ((0, 2), 0.1, None)],
        dtype=object)
    np.savez(str(root / "scene.npz"),
             image_paths=np.array(image_paths, object),
             depth_paths=np.array(depth_paths, object),
             intrinsics=np.array(intrinsics, object),
             poses=np.array(poses, object),
             pair_infos=pair_infos)
    return root


def assert_items_equal(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k in want:
        if isinstance(want[k], np.ndarray):
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            assert got[k] == want[k], k


def _scannet(mod, root, npz="pairs.npz", mode="train"):
    return mod.ScanNetDataset(str(root), str(root / npz),
                              str(root / "intrinsics.npz"), mode=mode)


@pytest.mark.parametrize("npz,mode", [("pairs.npz", "train"),
                                      ("pairs.npz", "val"),
                                      ("test.npz", "test")])
def test_scannet_items_equal(scannet_root, npz, mode):
    got = _scannet(td, scannet_root, npz, mode)
    want = _scannet(jd, scannet_root, npz, mode)
    assert len(got) == len(want) > 0
    for i in range(len(want)):
        assert_items_equal(got[i], want[i])


MD_KW = {"train": dict(min_overlap_score=0.4, img_resize=320, df=8,
                       img_padding=True, depth_padding=True),
         "test": dict(min_overlap_score=0.0, img_resize=256, df=8,
                      img_padding=True, depth_padding=False),
         "val": dict(min_overlap_score=0.0, img_resize=None, df=None,
                     img_padding=False, depth_padding=False)}


@pytest.mark.parametrize("mode", ["train", "test", "val"])
def test_megadepth_items_equal(megadepth_root, mode):
    args = (str(megadepth_root), str(megadepth_root / "scene.npz"))
    got = td.MegaDepthDataset(*args, mode=mode, **MD_KW[mode])
    want = jd.MegaDepthDataset(*args, mode=mode, **MD_KW[mode])
    assert len(got) == len(want) > 0
    for i in range(len(want)):
        assert_items_equal(got[i], want[i])


@pytest.mark.parametrize("scale", [0.125, 0.25])
def test_downsample_mask_nearest_equal(scale):
    mask = np.random.RandomState(2).rand(328, 328) > 0.4
    np.testing.assert_array_equal(tmd._downsample_mask_nearest(mask, scale),
                                  jmd._downsample_mask_nearest(mask, scale))


def _same_matchinput(got: MatchInput, want):
    for name in ("image0", "image1", "mask0", "mask1", "scale0", "scale1",
                 "depth0", "depth1", "T_0to1", "T_1to0", "K0", "K1"):
        g, w = getattr(got, name), getattr(want, name)
        if w is None:
            assert g is None, name
            continue
        assert isinstance(g, torch.Tensor) and g.device.type == "cpu", name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


@pytest.mark.parametrize("mode", ["train", "test"])
def test_collate_and_loader_equal(megadepth_root, mode):
    args = (str(megadepth_root), str(megadepth_root / "scene.npz"))
    tds = td.MegaDepthDataset(*args, mode=mode, **MD_KW[mode])
    jds = jd.MegaDepthDataset(*args, mode=mode, **MD_KW[mode])
    g, gm = td.collate_matchinput([tds[0], tds[1]])
    w, wm = jd.collate_matchinput([jds[0], jds[1]])
    _same_matchinput(g, w)
    assert gm == wm
    got = list(td.DataLoader(tds, batch_size=1, sampler=[1, 0],
                             num_workers=2, drop_last=False))
    want = list(jd.DataLoader(jds, batch_size=1, sampler=[1, 0],
                              num_workers=2, drop_last=False))
    assert len(got) == len(want) == 2
    for (g, gm), (w, wm) in zip(got, want):
        _same_matchinput(g, w)
        assert gm == wm


def test_scannet_loader_has_no_masks(scannet_root):
    (inp, meta), = list(td.DataLoader(_scannet(td, scannet_root),
                                      batch_size=2, num_workers=2))
    assert inp.image0.shape == (2, 480, 640, 1)
    assert inp.mask0 is None and inp.scale0 is None
    assert meta[0]["scene_id"] == "scene0000_00"


def test_loader_propagates_errors():
    class Broken:
        def __len__(self):
            return 4

        def __getitem__(self, i):
            raise RuntimeError("decode failure")

    with pytest.raises(RuntimeError, match="decode failure"):
        list(td.DataLoader(Broken(), batch_size=2))


class _Sized:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return ("item", self.n, i)


@pytest.mark.parametrize("replacement,shuffle,repeat", [
    (True, True, 1), (False, True, 2), (False, False, 1), (True, False, 3)])
def test_sampler_equal(replacement, shuffle, repeat):
    sizes = [5, 2, 7]
    got_c = tsamp.ConcatDataset([_Sized(n) for n in sizes])
    want_c = jsamp.ConcatDataset([_Sized(n) for n in sizes])
    assert [got_c[i] for i in range(len(got_c))] == \
        [want_c[i] for i in range(len(want_c))]
    kw = dict(n_samples_per_subset=4, subset_replacement=replacement,
              shuffle=shuffle, repeat=repeat, seed=3)
    got = td.SceneBalancedSampler(got_c, **kw)
    want = jd.SceneBalancedSampler(want_c, **kw)
    for _ in range(2):                      # stateful across epochs
        assert list(got) == list(want)


@pytest.mark.parametrize("n,world", [(10, 4), (8, 4), (3, 2)])
def test_get_local_split_equal(n, world):
    items = [f"s{i}" for i in range(n)]
    for rank in range(world):
        assert td.get_local_split(items, world, rank, seed=1) == \
            jd.get_local_split(items, world, rank, seed=1)


@pytest.mark.parametrize("method", ["dark", "mobile"])
def test_augmentors_equal(method):
    img = (np.random.RandomState(0).rand(64, 80) * 255).astype(np.uint8)
    got_aug, want_aug = taug.build_augmentor(method), \
        jaug.build_augmentor(method)
    for s in range(12):
        np.testing.assert_array_equal(
            got_aug(img, np.random.default_rng(s)),
            want_aug(img, np.random.default_rng(s)))
    assert taug.build_augmentor(None) is None
    with pytest.raises(ValueError):
        taug.build_augmentor("FDA")


def test_synthetic_megadepth_equal(tmp_path):
    kw = dict(n_scenes=2, n_views=3, img_size=64, seed=4)
    got = tsyn.make_synthetic_megadepth(str(tmp_path / "t"), **kw)
    want = jsyn.make_synthetic_megadepth(str(tmp_path / "j"), **kw)
    assert [os.path.relpath(p, tmp_path / "t") for p in got] == \
        [os.path.relpath(p, tmp_path / "j") for p in want]
    for gp, wp in zip(got, want):
        g, w = np.load(gp, allow_pickle=True), np.load(wp, allow_pickle=True)
        for k in ("image_paths", "depth_paths", "intrinsics", "poses"):
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        assert [tuple(p[:2]) for p in g["pair_infos"]] == \
            [tuple(p[:2]) for p in w["pair_infos"]]
        for ip, dp in zip(w["image_paths"], w["depth_paths"]):
            np.testing.assert_array_equal(
                cv2.imread(str(tmp_path / "t" / ip), cv2.IMREAD_UNCHANGED),
                cv2.imread(str(tmp_path / "j" / ip), cv2.IMREAD_UNCHANGED))
            with h5py.File(tmp_path / "t" / dp) as a, \
                    h5py.File(tmp_path / "j" / dp) as b:
                np.testing.assert_array_equal(a["depth"][()], b["depth"][()])
    with open(tmp_path / "t" / "index" / "scene_list.txt") as f:
        assert f.read() == "synth_0000\nsynth_0001\n"


def test_synthetic_npy_depth_without_h5py(tmp_path, monkeypatch):
    """Asked for .npy depth, the writer needs no h5py and stores .npy; the
    dataset reads it as the same array the .h5 file holds.  Asked for .h5
    without h5py, it raises: the format never follows the environment."""
    kw = dict(n_scenes=1, n_views=2, img_size=64, seed=5)
    (h5_npz,) = tsyn.make_synthetic_megadepth(str(tmp_path / "h5"), **kw)
    assert all(p.endswith(".h5")
               for p in np.load(h5_npz, allow_pickle=True)["depth_paths"])
    want = td.MegaDepthDataset(str(tmp_path / "h5"), h5_npz, mode="val")[0]
    monkeypatch.setitem(sys.modules, "h5py", None)     # import h5py fails
    (npy_npz,) = tsyn.make_synthetic_megadepth(str(tmp_path / "npy"),
                                               depth_format="npy", **kw)
    assert all(p.endswith(".npy")
               for p in np.load(npy_npz, allow_pickle=True)["depth_paths"])
    with pytest.raises(ImportError):
        tsyn.make_synthetic_megadepth(str(tmp_path / "h5b"), **kw)
    got = td.MegaDepthDataset(str(tmp_path / "npy"), npy_npz, mode="val")[0]
    for k in ("image0", "image1", "depth0", "depth1", "T_0to1", "K0"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
