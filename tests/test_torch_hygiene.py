"""The port stands alone: importing repro_torch and every module of the
serving, training and mesh slices loads neither jax, nor the JAX package, nor
networkx (the card's machine has none; the port's triangle partitions
match diagonals with their own Hopcroft–Karp), and the entry points
refuse to run on the host unless asked."""
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MODULES = [
    "repro_torch", "repro_torch.device", "repro_torch.configs",
    "repro_torch.configs.stablelm_1_6b", "repro_torch.core.packing",
    "repro_torch.kernels.ref", "repro_torch.kernels.native",
    "repro_torch.kernels.trigrid", "repro_torch.kernels.syrk",
    "repro_torch.kernels.syr2k", "repro_torch.kernels.symm",
    "repro_torch.blas", "repro_torch.blas.autotune",
    "repro_torch.blas.routing", "repro_torch.blas.api",
    "repro_torch.optim.gram", "repro_torch.models.common",
    "repro_torch.models.attention", "repro_torch.models.moe",
    "repro_torch.models.model", "repro_torch.launch.steps",
    "repro_torch.launch.serving_cache", "repro_torch.launch.serve",
    "repro_torch.kernels.slstm", "repro_torch.models.ssm",
    "repro_torch.configs.xlstm_350m", "repro_torch.kernels.counts",
    "repro_torch.core.gf", "repro_torch.core.triangle",
    "repro_torch.core.lower_bounds", "repro_torch.core.dispatch",
    "repro_torch.core.seq", "repro_torch.kernels.ops",
    "repro_torch.blas.grad", "repro_torch.optim.adamw",
    "repro_torch.optim.muon", "repro_torch.data",
    "repro_torch.data.pipeline", "repro_torch.distributed",
    "repro_torch.distributed.straggler", "repro_torch.launch.train",
    "repro_torch.core.twodim", "repro_torch.core.onedim",
    "repro_torch.core.ringpath", "repro_torch.core.threedim",
    "repro_torch.blas.meshpath", "repro_torch.distributed.mesh",
    "repro_torch.distributed.collectives",
    "repro_torch.distributed.launch",
]

_PROBE = r"""
import importlib, sys
for m in %r:
    importlib.import_module(m)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m.startswith("jaxlib.") or m == "repro"
             or m.startswith("repro.") or m == "networkx"
             or m.startswith("networkx."))
assert not bad, bad
print("PORT-STANDS-ALONE", len(%r))
"""


def test_port_imports_neither_jax_nor_repro():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", _PROBE % (MODULES, MODULES)],
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert f"PORT-STANDS-ALONE {len(MODULES)}" in out.stdout


def test_chip_smoke_imports_neither_jax_nor_repro():
    src = open(os.path.join(ROOT, "chip_smoke.py")).read()
    for line in src.splitlines():
        words = line.replace(",", " ").split()
        if words[:1] in (["import"], ["from"]):
            assert words[1].split(".")[0] not in ("jax", "repro"), line


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_gpu_or_the_repo(tmp_path, alone):
    """No CUDA device here: the smoke run exits non-zero and prints no
    result, in the checkout and as a lone copy of the script."""
    script = os.path.join(ROOT, "chip_smoke.py")
    if alone:
        (tmp_path / "chip_smoke.py").write_text(open(script).read())
        script = str(tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, script], capture_output=True,
                         text=True, env=env, cwd=tmp_path, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_entry_points_raise_without_a_gpu(monkeypatch):
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.serve import Server
    from repro_torch.models.model import init_model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke_config("stablelm-1.6b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_model(cfg)
    model = init_model(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Server(cfg, model, slots=1, s_max=16, max_new=1)
    with pytest.raises(RuntimeError):
        init_model(cfg, device="cuda")
    from repro_torch.launch.train import build_argparser, train
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train(build_argparser().parse_args(["--steps", "1"]))


def test_mesh_entry_points_raise_without_a_gpu(monkeypatch, tmp_path):
    """``run_ranks`` and ``make_mesh`` with no device run on the card and
    raise without one; the host only when asked for."""
    import torch.distributed as dist

    from repro_torch.distributed.launch import run_ranks
    from repro_torch.distributed.mesh import init_distributed, make_mesh
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_ranks("repro_torch.device:describe", 2)
    with pytest.raises(RuntimeError):
        run_ranks("repro_torch.device:describe", 2, device="cuda:0")
    init_distributed(0, 1, f"file://{tmp_path}/rendezvous", "gloo")
    try:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_mesh()
        assert make_mesh(device="cpu").device == torch.device("cpu")
    finally:
        dist.destroy_process_group()


def test_tf32_is_off():
    from repro_torch.device import resolve_device
    torch.backends.cuda.matmul.allow_tf32 = True
    resolve_device("cpu")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
