"""The port stands alone: importing repro_torch and every module of the
serving, training, mesh and checkpoint slices loads neither jax, nor the
JAX package, nor networkx, nor ml_dtypes (the card's machine has neither
of the last two; the port's triangle partitions match diagonals with
their own Hopcroft–Karp, and its checkpoints write bf16 words without
ml_dtypes), and the entry points refuse to run on the host unless
asked.  The dry run, which counts on the meta device, touches no card."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def limit_torch_threads():
    """Hold a test module's torch to a share of the host's cores, as
    ``distributed.launch`` holds each rank: under several test workers
    a process of one core's worth of small ops with every core's
    intra-op threads spends most of its time waiting on them.  The
    modules that import it run under it; the count is put back after."""
    before = torch.get_num_threads()
    torch.set_num_threads(max(1, min(before, (os.cpu_count() or 1) // 4)))
    yield
    torch.set_num_threads(before)


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
    "repro_torch.distributed.checkpoint",
    "repro_torch.distributed.resilience",
    "repro_torch.distributed.faults", "repro_torch.launch.recovery",
    "repro_torch.distributed.compression",
    "repro_torch.distributed.elastic", "repro_torch.launch.mesh",
    "repro_torch.models.sharding", "repro_torch.configs.jamba_v0_1_52b",
    "repro_torch.configs.gemma2_9b", "repro_torch.configs.gemma3_12b",
    "repro_torch.configs.granite_20b", "repro_torch.configs.pixtral_12b",
    "repro_torch.configs.musicgen_large",
    "repro_torch.configs.deepseek_v2_236b",
    "repro_torch.configs.deepseek_v3_671b", "repro_torch.configs.shapes",
    "repro_torch.analysis", "repro_torch.analysis.op_cost",
    "repro_torch.analysis.roofline", "repro_torch.launch.dryrun",
]

_PROBE = r"""
import importlib, sys
for m in %r:
    importlib.import_module(m)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m.startswith("jaxlib.") or m == "repro"
             or m.startswith("repro.") or m == "networkx"
             or m.startswith("networkx.") or m == "ml_dtypes"
             or m.startswith("ml_dtypes."))
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


def test_entry_points_raise_without_a_gpu(monkeypatch, tmp_path):
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
    from repro_torch.launch.serving_cache import ServingGramCache
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingGramCache().warm_start(str(tmp_path))
    from repro_torch.launch.recovery import run_recovery
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_recovery(str(tmp_path / "ckpt"), steps=2, kill_step=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train(build_argparser().parse_args(["--steps", "1", "--fail-at",
                                            "0"]))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train(build_argparser().parse_args(["--steps", "1", "--devices",
                                            "2"]))


@pytest.mark.parametrize("arch", ["gemma2-9b", "gemma3-12b", "granite-20b",
                                  "pixtral-12b", "musicgen-large"])
def test_dense_family_entry_points_raise_without_a_gpu(monkeypatch, arch):
    """The dense families' entry points want the card as the others do:
    ``init_model`` and, for the four token families, ``serve()`` raise
    without one; musicgen's frames are refused by the server first."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.serve import build_argparser, serve
    from repro_torch.models.model import init_model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_model(get_smoke_config(arch))
    args = build_argparser().parse_args(["--arch", arch])
    if arch == "musicgen-large":
        with pytest.raises(NotImplementedError, match="takes frames"):
            serve(args)
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            serve(args)


@pytest.mark.parametrize("arch", ["gemma2-9b", "gemma3-12b", "granite-20b",
                                  "pixtral-12b", "musicgen-large"])
def test_dense_family_trainer_raises_without_a_gpu(monkeypatch, arch):
    """The trainer of the dense families wants the card as the others
    do, on one device and on a mesh (granite's model axis at 1: its one
    KV head); musicgen's frames are refused first, as the server does."""
    from repro_torch.launch.train import build_argparser, train
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for mesh in ([], ["--devices", "4", "--max-model",
                      "1" if arch == "granite-20b" else "2"]):
        args = build_argparser().parse_args(["--arch", arch, "--steps",
                                             "1"] + mesh)
        if arch == "musicgen-large":
            with pytest.raises(NotImplementedError, match="takes frames"):
                train(args)
        else:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                train(args)


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "deepseek-v3-671b"])
def test_deepseek_entry_points_raise_without_a_gpu(monkeypatch, arch):
    """``init_model`` and ``serve()`` of the deepseek configs want the
    card as the others do."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.serve import build_argparser, serve
    from repro_torch.models.model import init_model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_model(get_smoke_config(arch))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve(build_argparser().parse_args(["--arch", arch]))


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


_DRYRUN_PROBE = r"""
import sys, torch
def refuse():
    raise AssertionError("the dry run touched CUDA")
torch.cuda._lazy_init = refuse
from repro_torch.launch.dryrun import main
for arch, shape in (("xlstm_350m", "long_500k"),
                    ("stablelm_1_6b", "decode_32k")):
    assert main(["--arch", arch, "--shape", shape, "--out", sys.argv[1]]) == 0
assert not torch.cuda.is_initialized()
print("DRYRUN-DEVICE-FREE")
"""


def test_dryrun_runs_with_cuda_hidden_and_touches_no_card(tmp_path):
    """The dry run is device-free by design (meta tensors), not a host
    fallback: with CUDA hidden and CUDA's initialisation made to raise,
    full-width cells count and write their records."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", _DRYRUN_PROBE,
                          str(tmp_path / "d.jsonl")], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "DRYRUN-DEVICE-FREE" in out.stdout
    recs = (tmp_path / "d.jsonl").read_text().splitlines()
    assert len(recs) == 2 and all('"status": "ok"' in r for r in recs)


def test_tf32_is_off():
    from repro_torch.device import resolve_device
    torch.backends.cuda.matmul.allow_tf32 = True
    resolve_device("cpu")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


@pytest.mark.parametrize("devices", [1, 4])
def test_jamba_training_and_mesh_refuse(monkeypatch, devices):
    """jamba trains on one device (one step of the smoke config on the
    host; without ``--device cpu`` and no card it raises as the other
    configs do) and on a mesh whose model axis divides its KV heads
    (tests/test_torch_jamba_mesh.py); a model axis of 4 would cut the
    smoke config's 2 KV heads, and raises ``ValueError`` before any
    weight is drawn, from the trainer, ``shard_`` and
    ``check_head_split`` alike."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed.mesh import planning_mesh
    from repro_torch.launch import train as ttrain
    from repro_torch.models.model import check_head_split, init_model
    from repro_torch.models.sharding import param_specs
    argv = ["--arch", "jamba-v0.1-52b", "--steps", "1", "--devices",
            str(devices), "--global-batch", "2", "--seq-len", "32"]
    if devices == 1:
        out = ttrain.train(ttrain.build_argparser().parse_args(
            argv + ["--device", "cpu"]))
        assert out["steps"] == 1 and np.isfinite(out["losses"][0])
        with monkeypatch.context() as m:
            m.setattr(torch.cuda, "is_available", lambda: False)
            with pytest.raises(RuntimeError, match="device='cpu'"):
                ttrain.train(ttrain.build_argparser().parse_args(argv))
    else:
        def no_init(*a, **kw):
            raise AssertionError("weights drawn before the refusal")
        with monkeypatch.context() as m:
            m.setattr(ttrain, "init_model", no_init)
            m.setattr(ttrain, "run_ranks", no_init)
            with pytest.raises(ValueError, match="n_kv_heads=2"):
                ttrain.train(ttrain.build_argparser().parse_args(
                    argv + ["--device", "cpu", "--max-model", "4"]))
    cfg = get_smoke_config("jamba-v0.1-52b")
    mesh = planning_mesh({"data": 4 // devices, "model": devices})
    specs = param_specs(cfg, init_model(cfg, device="cpu").stacked_shapes(),
                        mesh)
    if devices == 1:
        check_head_split(cfg, specs, devices)       # nothing waits
        return
    with pytest.raises(ValueError, match="n_kv_heads=2"):
        init_model(cfg, device="cpu").shard_(mesh)
    with pytest.raises(ValueError, match="n_kv_heads=2"):
        check_head_split(cfg, specs, devices)
