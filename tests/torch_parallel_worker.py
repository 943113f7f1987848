"""Ranks of the port's multi-process CPU tests (gloo).

    python tests/torch_parallel_worker.py CHECK RANK WORLD STORE OUT_DIR

runs one rank of ``CHECK`` (a function of this file) in a process group
over the ``file://`` store ``STORE`` with one intra-op thread; its inputs
are files the test wrote under ``OUT_DIR`` and its results go to
``OUT_DIR/CHECK_<RANK>.pt``.  The module imports neither JAX nor the JAX
package: the tests compare the records with JAX themselves.
:func:`start_ranks` starts the ranks of one check, :func:`wait_ranks`
waits for them.
"""
import contextlib
import os
import subprocess
import sys
import time

import numpy as np
import torch

from chip_smoke import recording_grads

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@contextlib.contextmanager
def one_rank_group(store):
    """A gloo process group of this process alone over the ``file://``
    store ``store``, destroyed afterwards."""
    torch.distributed.init_process_group(
        "gloo", init_method="file://" + str(store), rank=0, world_size=1)
    try:
        yield torch.distributed.group.WORLD
    finally:
        torch.distributed.destroy_process_group()


def start_ranks(check, out_dir, world=2, timeout=120.0, env=None):
    """Start ``world`` ranks of ``check``; :func:`wait_ranks` collects
    them.  The ranks must end within ``timeout`` seconds of their start."""
    store = os.path.join(str(out_dir), f"store_{check}")
    e = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
             **(env or {}))
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), check, str(r),
         str(world), store, str(out_dir)], env=e, cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    return check, out_dir, procs, time.time() + timeout, timeout


def wait_ranks(handle):
    """Wait for the ranks of :func:`start_ranks`; a rank that fails, or a
    run past its timeout, raises with the ranks' output.  Returns the
    ranks' records in rank order."""
    check, out_dir, procs, deadline, timeout = handle
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(
                timeout=max(1.0, deadline - time.time()))[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        outs = [p.communicate()[0] for p in procs]
        raise AssertionError(f"{check}: ranks ran past {timeout} s:\n"
                             + "\n".join(o[-3000:] for o in outs))
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"{check}: rank {r} failed:\n{out[-6000:]}")
    return [torch.load(os.path.join(str(out_dir), f"{check}_{r}.pt"),
                       weights_only=False) for r in range(len(procs))]


def run_ranks(check, out_dir, world=2, timeout=120.0, env=None):
    """:func:`start_ranks` then :func:`wait_ranks`."""
    return wait_ranks(start_ranks(check, out_dir, world, timeout, env))


def _wait_for(path, timeout=120.0):
    """The path once the test has written it (it renames the finished
    file into place)."""
    deadline = time.time() + timeout
    while not os.path.exists(path):
        if time.time() > deadline:
            raise TimeoutError(path)
        time.sleep(0.05)
    return path


def save_spec(obj, path):
    """torch.save, then a rename: a waiting rank reads a whole file."""
    torch.save(obj, path + ".part")
    os.replace(path + ".part", path)


# ------------------------------------------------------------------ checks

def comm_check(rank, world, out):
    """Collectives, the mesh, replicate and the evaluator merge."""
    from loftr_tpu_torch.parallel import comm
    from loftr_tpu_torch.parallel.mesh import make_mesh, replicate, shard_batch
    rec = {}
    rec["objects"] = comm.process_allgather_objects(
        {"identifiers": [f"scene{rank}#p{i}" for i in range(rank + 1)],
         "epi_errs": [np.arange(rank + 2, dtype=np.float32)]})

    # all_reduce_sum: y = sum_r x_r; rank r's loss part (r + 1) * y
    x = torch.full((3,), float(rank + 1), requires_grad=True)
    y = comm.all_reduce_sum(x * x)
    ((rank + 1) * y).sum().backward()
    rec["reduce"] = (y.detach(), x.grad.clone())

    # all_gather along dim 1; the consumer sum(w * g) runs alike on every
    # rank, so the gradient of this rank's slice is w's slice
    a = torch.arange(6.0).reshape(2, 3) + 10 * rank
    a.requires_grad_(True)
    g = comm.all_gather(a, dim=1)
    w = torch.arange(12.0).reshape(2, 6)
    (w * g).sum().backward()
    rec["gather"] = (g.detach(), a.grad.clone())

    # ring_shift: forward from the previous rank, gradient to it
    b = torch.full((2,), float(rank), requires_grad=True)
    s = comm.ring_shift(b)
    (s * (rank + 1)).sum().backward()
    rec["ring"] = (s.detach(), b.grad.clone())

    mesh = make_mesh()
    rec["mesh"] = (mesh.shape, mesh.coords, comm.group_size(
        mesh.group("data")), comm.group_size(mesh.group("model")))
    rec["rows"] = shard_batch(mesh, {"x": torch.arange(8).reshape(4, 2),
                                     "none": None})
    torch.manual_seed(rank)
    lin = torch.nn.Linear(3, 2)
    lin.register_buffer("stat", torch.full((2,), float(rank)))
    replicate(lin)
    rec["replicated"] = {k: v.clone() for k, v in lin.state_dict().items()}

    # the evaluator over this rank's pairs, merged across the ranks
    from loftr_tpu_torch import get_config
    from loftr_tpu_torch.data.megadepth import MegaDepthDataset
    from loftr_tpu_torch.data.sampler import ConcatDataset
    from loftr_tpu_torch.eval.evaluator import Evaluator
    from loftr_tpu_torch.models.matcher import LoFTR
    spec = torch.load(os.path.join(out, "eval_spec.pt"), weights_only=False)
    cfg = get_config("outdoor_ds", spec["overrides"])
    model = LoFTR(cfg.loftr)
    model.load_state_dict(spec["state"])
    ds = ConcatDataset([MegaDepthDataset(
        spec["root"], n, mode="test", img_resize=spec["size"], df=8,
        img_padding=True) for n in spec["npz"]])
    ev = Evaluator(cfg, model.eval(), pose_solver="native", device="cpu")
    rec["eval"] = ev.evaluate_dataset(ds, batch_size=1, num_workers=0,
                                      world_size=world, rank=rank)
    return rec


def train_check(rank, world, out):
    """One data-parallel Trainer step per route, and the selection."""
    from loftr_tpu_torch import get_config
    from loftr_tpu_torch.ops.matching import CandidateMatches
    from loftr_tpu_torch.ops.matching import select_train_matches
    from loftr_tpu_torch.parallel import comm
    from loftr_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from loftr_tpu_torch.structs import MatchInput
    from loftr_tpu_torch.train.trainer import Trainer
    spec = torch.load(_wait_for(os.path.join(out, "train_spec.pt")),
                      weights_only=False)
    mesh = make_mesh()
    batch = shard_batch(mesh, MatchInput(**spec["batch"]))
    rec = {}
    for route, overrides in spec["routes"].items():
        trainer = Trainer(get_config("indoor_ds", overrides), world_size=world,
                          device="cpu")
        # rank 1 starts from other weights: replicate gives it rank 0's
        state = trainer.init_state(
            seed=0, state_dict=spec["init"] if rank == 0 else None)
        sd0 = {k: v.clone() for k, v in state.module.state_dict().items()}
        grads = recording_grads(trainer, state)
        state, scalars = trainer.train_step(state, batch, noise=spec["noise"])
        rec[route] = {"start": sd0, "scalars": {k: float(v) for k, v in
                                                scalars.items()},
                      "after": state.module.state_dict(), "grads": grads,
                      "packing": trainer.config.loftr.batch_packing}
    sel = spec["select"]
    cand = CandidateMatches(**shard_batch(mesh, sel["cand"]))
    gt = shard_batch(mesh, {"gt_j": sel["gt_j"], "gt_valid": sel["gt_valid"]})
    with comm.data_parallel(mesh.group("data"), cand.valid.shape[0]):
        m = select_train_matches(cand, gt["gt_j"], gt["gt_valid"], None,
                                 sel["k_train"], sel["pad"],
                                 sampling="global_replacement",
                                 noise=sel["noise"])
    rec["select"] = {k: getattr(m, k) for k in
                     ("i_ids", "j_ids", "mconf", "mask", "gt_mask")}
    return rec


def ba_check(rank, world, out):
    """One sharded LM iteration per case, and a sharded loop."""
    from loftr_tpu_torch.parallel.mesh import make_mesh
    from loftr_tpu_torch.sfm import bundle_adjustment as T
    spec = torch.load(_wait_for(os.path.join(out, "ba_spec.pt")),
                      weights_only=False)
    mesh = make_mesh()
    rec = {}
    for name, case in spec.items():
        prob = T.BAProblem(**case["arrays"])
        prob = prob.replace(obs_cam=prob.obs_cam.long())
        if case.get("float64"):
            prob = prob.replace(**{k: getattr(prob, k).double() for k in
                                   ("R", "t", "points", "obs_uv", "obs_w")})
        shard = T.shard_problem(prob, mesh)
        if case.get("loop"):
            solved, cost = T.bundle_adjust_sharded(
                shard, mesh, max_iters=case["max_iters"],
                solver=case["solver"])
            rec[name] = {"R": solved.R, "t": solved.t,
                         "points": solved.points, "cost": cost}
            continue
        step = T.make_sharded_ba_iteration(mesh, "data", case["solver"],
                                           case["cg_iters"])
        new, old_cost, new_cost = step(shard, 1e-4)
        rec[name] = {"R": new.R, "t": new.t, "points": new.points,
                     "old": float(old_cost), "new": float(new_cost)}
    return rec


def seq_check(rank, world, out):
    """Sequence-parallel attention (forward and gradient), the token-sharded
    coarse stack (forward, gradients) and a matcher with coarse.seq_axis."""
    from loftr_tpu_torch import get_config
    from loftr_tpu_torch.models.matcher import LoFTR
    from loftr_tpu_torch.models.transformer import LocalFeatureTransformer
    from loftr_tpu_torch.parallel.mesh import make_seq_mesh
    from loftr_tpu_torch.parallel.seq_attention import (
        make_sharded_attention, sharded_coarse_stack, token_shard)
    from loftr_tpu_torch.structs import MatchInput
    spec = torch.load(_wait_for(os.path.join(out, "seq_spec.pt")),
                      weights_only=False)
    mesh = make_seq_mesh(1, world)
    group = mesh.group("seq")
    rec = {}
    a = spec["attention"]
    for kind in ("linear", "full"):
        q, k, v, w = (token_shard(a[n], group).clone().requires_grad_(True)
                      if n != "w" else token_shard(a[n], group)
                      for n in ("q", "k", "v", "w"))
        qm, km = (token_shard(a[n + kind], group) for n in ("qm_", "km_"))
        o = make_sharded_attention(group, kind)(q, k, v, qm, km)
        # this rank's part of the loss sum(out * w)
        (o * w).sum().backward()
        rec[kind] = {"out": o.detach(), "grads": (q.grad, k.grad, v.grad)}

    st = spec["stack"]
    for kind in ("linear", "full"):
        stack = LocalFeatureTransformer(st["d"], st["h"], st["names"], kind)
        stack.load_state_dict(st["state_" + kind])
        f0, f1 = (st[n].clone().requires_grad_(True) for n in ("f0", "f1"))
        c0, c1 = sharded_coarse_stack(stack, f0, f1, st["m0"], st["m1"],
                                      "concat", group)
        # every rank runs the same (replicated) loss on the gathered tokens
        ((c0 * st["w0"]).sum() + (c1 * st["w1"]).sum()).backward()
        rec["stack_" + kind] = {
            "c0": c0.detach(), "c1": c1.detach(),
            "param_grads": {n: p.grad.clone()
                            for n, p in stack.named_parameters()},
            "f0_grad": f0.grad, "f1_grad": f1.grad}

    m = spec["matcher"]
    model = LoFTR(get_config("indoor_ds", m["overrides"]).loftr)
    model.load_state_dict(m["state"])
    model.eval()
    with torch.no_grad(), mesh:
        inp = MatchInput(**m["batch"])
        f = model.extract(inp)
        rec["matcher"] = {"coarse": model.coarse(f)[:2],
                          "out": model(inp)}
    return rec


def main():
    check, rank, world, store, out = sys.argv[1:6]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    from loftr_tpu_torch.parallel.mesh import init_process_group
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world))
    init_process_group("cpu", init_method="file://" + store)
    try:
        rec = globals()[check + "_check"](rank, world, out)
        torch.save(rec, os.path.join(out, f"{check}_{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
