"""Nothing the harness runs may load JAX, its libraries or the JAX package
(top-level names compared whole: ``loftr_tpu_torch`` is the port)."""
import ast
import os
import subprocess
import sys

from bench_port import core

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_forbidden_names_are_whole_top_level_names():
    assert core.forbidden_loaded(["loftr_tpu_torch", "loftr_tpu_torch.api",
                                  "jaxtyping", "flaxen", "numpy"]) == []
    assert core.forbidden_loaded(["jax.numpy", "loftr_tpu.models",
                                  "flax", "jaxlib"]) == [
        "flax", "jax.numpy", "jaxlib", "loftr_tpu.models"]


def test_no_source_file_imports_a_forbidden_module():
    bad = []
    for root, _, files in os.walk(HERE):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(root, f)
            tree = ast.parse(open(path).read(), path)
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.module \
                        and node.level == 0:
                    names = [node.module]
                else:
                    continue
                bad += [(path, n) for n in core.forbidden_loaded(names)]
    assert bad == []


def test_loading_the_harness_loads_no_forbidden_module():
    """Every module a run imports (the harness, each generator, reader,
    reference and the port's modules the generators reach), in a fresh
    interpreter."""
    code = (
        "import sys, json\n"
        "from bench_port import run, core, check, control, readings\n"
        "from bench_port.generators import offline, train\n"
        "from bench_port.reference import loftr_plain, train_plain\n"
        "core.metric_readers()\n"
        "for w in json.load(open('BENCHMARK.json'))['workloads']:\n"
        "    core.load_cell(w['name'])\n"
        "from loftr_tpu_torch.api import load_matcher, optimize_variables\n"
        "from loftr_tpu_torch.train.trainer import Trainer\n"
        "from loftr_tpu_torch.ops.kernels import launch_counts\n"
        "print(json.dumps(core.forbidden_loaded(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=os.path.dirname(
        HERE), capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
