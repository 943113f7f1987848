"""Dataset evaluator: matcher -> epipolar errors -> pose -> AUC aggregation
(``loftr_tpu.eval.evaluator``; the reference's test.py and
lightning_loftr.py:205-249).

Per batch: the forward under ``torch.inference_mode`` on the device, the
symmetric epipolar errors against the ground-truth pose on the device, then
the relative pose of each pair by one of the solvers:

  - ``opencv``: cv2.findEssentialMat + recoverPose on the host (parity with
    the reference's published numbers, metrics.py:72-98);
  - ``native``: the in-tree C++ LO-RANSAC on the host (native.py);
  - ``5pt``: the host LO-RANSAC on minimal 5-point hypotheses
    (eval/five_point.py);
  - ``batched`` / ``batched5pt``: the batched RANSAC on the device, 8-point
    or minimal 5-point hypotheses (eval/ransac.py; the JAX package's
    ``jax`` / ``jax5pt``).

Results aggregate to pose AUC@{5,10,20} and precision at the epipolar
threshold.  In a process group of several ranks each rank evaluates its
pairs and the per-pair lists are merged across the ranks before the
aggregation (:func:`_merge_across_processes`), so every rank returns the
metrics of the whole set.
"""
from __future__ import annotations

import time
from typing import Dict, Iterable, Optional, Union

import numpy as np
import torch

from loftr_tpu_torch.api import resolve_device
from loftr_tpu_torch.config import Config
from loftr_tpu_torch.data.loader import DataLoader
from loftr_tpu_torch.eval import ransac
from loftr_tpu_torch.eval.metrics import (aggregate_metrics,
                                          essential_from_pose,
                                          relative_pose_error,
                                          symmetric_epipolar_distance)
from loftr_tpu_torch.models.matcher import LoFTR
from loftr_tpu_torch.parallel.comm import (group_size,
                                           process_allgather_objects)

HOST_SOLVERS = ("opencv", "native", "5pt")
DEVICE_SOLVERS = ("batched", "batched5pt")


def _merge_across_processes(metrics: Dict[str, list]) -> Dict[str, list]:
    """Gather the raw per-pair metric lists of every rank (the JAX
    package's ``_merge_across_hosts``).  Under exact pair sharding each
    rank holds disjoint pairs; the lists hold strings and ragged arrays, so
    they travel as pickled objects (``parallel.comm.
    process_allgather_objects``) and are concatenated in rank order.  The
    lists themselves in one process."""
    parts = process_allgather_objects(metrics)
    if len(parts) == 1:
        return metrics
    merged = {k: [] for k in metrics}
    for part in parts:
        for k, v in part.items():
            merged[k].extend(list(v))
    return merged


class Evaluator:
    def __init__(self, config: Config,
                 model: Union[torch.nn.Module, Dict[str, torch.Tensor]],
                 pose_solver: str = "opencv", num_hypotheses: int = 1024,
                 device="cuda", seed: int = 0):
        """model: a LoFTR module (each evaluation runs it in eval mode and
        then restores the mode it had, so a training module can be
        validated between steps) or a state dict for
        ``LoFTR(config.loftr)``.  ``seed`` seeds the device solvers'
        sampling generator.  Runs on ``device`` (CUDA unless
        the caller asks for the CPU)."""
        if pose_solver not in HOST_SOLVERS + DEVICE_SOLVERS:
            raise ValueError(f"unknown pose solver {pose_solver!r}")
        self.device = resolve_device(device)
        if not isinstance(model, torch.nn.Module):
            state = model
            model = LoFTR(config.loftr)
            model.load_state_dict(state)
        self.model = model.to(self.device)
        self.config = config
        self.pose_solver = pose_solver
        self.num_hypotheses = num_hypotheses
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        # seconds of the last evaluate_batches: forward + epipolar errors
        # (to the host), and pose estimation; and the pairs evaluated
        self.timing = {"pairs": 0, "model_s": 0.0, "pose_s": 0.0}

    def _device_poses(self, kpts0, kpts1, K0, K1, valid):
        minimal = self.pose_solver == "batched5pt"
        n_hyp = (max(1, self.num_hypotheses // 8) if minimal
                 else self.num_hypotheses)
        return ransac.estimate_pose_ransac(
            kpts0, kpts1, K0, K1, valid,
            pixel_thr=self.config.trainer.ransac_pixel_thr,
            num_hypotheses=n_hyp, solver="5pt" if minimal else "8pt",
            generator=self.generator)

    def _host_pose(self, k0, k1, K0, K1):
        pixel_thr = self.config.trainer.ransac_pixel_thr
        if self.pose_solver == "opencv":
            from loftr_tpu_torch.eval.pose import estimate_pose_opencv
            return estimate_pose_opencv(k0, k1, K0, K1, pixel_thr,
                                        self.config.trainer.ransac_conf)
        if self.pose_solver == "native":
            from loftr_tpu_torch.native import estimate_pose_native
            return estimate_pose_native(k0, k1, K0, K1, pixel_thr,
                                        self.num_hypotheses)
        from loftr_tpu_torch.eval.five_point import estimate_pose_5pt
        return estimate_pose_5pt(k0, k1, K0, K1, pixel_thr)

    def evaluate_batches(self, batches: Iterable,
                         dump_path: Optional[str] = None,
                         figure_sink=None, n_figure_pairs: int = 8,
                         figure_conf_thr: float = 5e-4) -> Dict[str, float]:
        """batches: iterable of (MatchInput of CPU tensors, meta-list).

        dump_path: optional .npz path for per-pair records (the reference's
        --dump_dir, lightning_loftr.py:211-228; tools/visualize_dump.py
        renders them).  figure_sink: optional callable(list of matplotlib
        figures) for the first ``n_figure_pairs`` pairs, epi-error colored
        (plotting.py:112-133); closing them passes to the sink."""
        was_training = getattr(self.model, "training", None)
        if was_training is not None:
            self.model.eval()
        try:
            return self._evaluate(batches, dump_path, figure_sink,
                                  n_figure_pairs, figure_conf_thr)
        finally:
            if was_training is not None:
                self.model.train(was_training)

    def _evaluate(self, batches, dump_path, figure_sink, n_figure_pairs,
                  figure_conf_thr):
        metrics = {"identifiers": [], "R_errs": [], "t_errs": [],
                   "epi_errs": [], "n_matches": []}
        dumps = [] if dump_path else None
        figures_left = n_figure_pairs if figure_sink is not None else 0
        self.timing = {"pairs": 0, "model_s": 0.0, "pose_s": 0.0}

        for inp, meta in batches:
            t0 = time.perf_counter()
            inp = inp.to(self.device)
            with torch.inference_mode():
                result = self.model(inp)
                kp0 = result.mkpts0_f.float()
                kp1 = result.mkpts1_f.float()
                epi = symmetric_epipolar_distance(
                    kp0, kp1, essential_from_pose(inp.T_0to1), inp.K0,
                    inp.K1).cpu().numpy()
            valid = result.valid.cpu().numpy()
            kpts0, kpts1 = kp0.cpu().numpy(), kp1.cpu().numpy()
            K0, K1 = inp.K0.cpu().numpy(), inp.K1.cpu().numpy()
            T_0to1 = inp.T_0to1.cpu().numpy()
            self.timing["model_s"] += time.perf_counter() - t0

            B = valid.shape[0]
            self.timing["pairs"] += B
            if figures_left > 0:
                from loftr_tpu_torch.utils.plotting import (
                    make_matching_figures)
                import matplotlib.pyplot as plt
                figs = make_matching_figures(
                    result, inp, epi_errs=epi, conf_thr=figure_conf_thr)
                figure_sink(figs[:figures_left])
                for f in figs[figures_left:]:  # over quota: close them
                    plt.close(f)
                figures_left -= min(figures_left, B)

            t1 = time.perf_counter()
            est = None
            if self.pose_solver in DEVICE_SOLVERS:
                with torch.inference_mode():
                    est = self._device_poses(kp0, kp1, inp.K0, inp.K1,
                                             result.valid)
                R_all, t_all = est.R.cpu().numpy(), est.t.cpu().numpy()
                ok_all = est.ok.cpu().numpy()
            for b in range(B):
                v = valid[b]
                metrics["epi_errs"].append(epi[b][v])
                metrics["n_matches"].append(int(v.sum()))
                metrics["identifiers"].append(
                    f"{meta[b]['scene_id']}#{meta[b]['pair_id']}")
                if est is None:
                    ret = self._host_pose(kpts0[b][v], kpts1[b][v], K0[b],
                                          K1[b])
                    R, t = (None, None) if ret is None else ret[:2]
                elif ok_all[b]:
                    R, t = R_all[b], t_all[b]
                else:
                    R = t = None
                if R is None:
                    metrics["R_errs"].append(np.inf)
                    metrics["t_errs"].append(np.inf)
                    continue
                t_err, R_err = relative_pose_error(T_0to1[b], R, t)
                metrics["R_errs"].append(R_err)
                metrics["t_errs"].append(t_err)
                if dumps is not None:
                    dumps.append({
                        "identifier": metrics["identifiers"][-1],
                        "pair_names": meta[b].get("pair_names"),
                        "mkpts0_f": kpts0[b][v], "mkpts1_f": kpts1[b][v],
                        "mconf": result.coarse.mconf[b].float().cpu()
                        .numpy()[v],
                        "epi_errs": epi[b][v],
                        "R_err": R_err, "t_err": t_err,
                    })
            self.timing["pose_s"] += time.perf_counter() - t1

        if dumps is not None:
            np.savez_compressed(
                dump_path, records=np.asarray(dumps, dtype=object))
        metrics = _merge_across_processes(metrics)
        return aggregate_metrics(metrics, self.config.trainer.epi_err_thr)

    def evaluate_dataset(self, dataset, batch_size: int = 1,
                         num_workers: int = 4,
                         world_size: int = 1, rank: int = 0,
                         dump_path: Optional[str] = None,
                         figure_sink=None, n_figure_pairs: int = 8,
                         figure_conf_thr: float = 5e-4
                         ) -> Dict[str, float]:
        """Evaluate the pairs of ``dataset`` this rank owns (exact
        round-robin sharding of pair indices, no duplicates) and return the
        metrics of the whole set, merged across the process group, which
        must hold ``world_size`` ranks."""
        if world_size != group_size():
            raise ValueError(f"world_size {world_size} but the process "
                             f"group holds {group_size()} ranks")
        order = list(range(rank, len(dataset), world_size))
        loader = DataLoader(dataset, batch_size=batch_size, sampler=order,
                            num_workers=num_workers, drop_last=False)
        return self.evaluate_batches(loader, dump_path=dump_path,
                                     figure_sink=figure_sink,
                                     n_figure_pairs=n_figure_pairs,
                                     figure_conf_thr=figure_conf_thr)
