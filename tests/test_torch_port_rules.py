"""Rules the PyTorch port keeps: no JAX and nothing of the JAX repository's
`benchmarks/`, CUDA by default (and a clear error without it), kernels built
only when first launched, and a `recommend` CLI that runs end to end."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from seqrec_tpu_torch import runtime
from seqrec_tpu_torch.config import ModelConfig, RunConfig
from seqrec_tpu_torch.eval.infer import recommend
from seqrec_tpu_torch.models import build_model
from seqrec_tpu_torch.models.convert import flax_to_state_dict, random_params, save_npz
from seqrec_tpu_torch.ops import _build

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "seqrec_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "seqrec_tpu", "benchmarks")


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_nothing_of_the_jax_package(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_importing_the_whole_port_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import seqrec_tpu_torch\n"
        "for m in pkgutil.walk_packages(seqrec_tpu_torch.__path__, 'seqrec_tpu_torch.'):\n"
        "    if not m.name.endswith('__main__'):\n"
        "        importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_default_device_is_cuda_and_raises_without_it(monkeypatch):
    assert runtime.DEFAULT_DEVICE == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        runtime.resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_model(ModelConfig(), 10)
    assert runtime.resolve_device("cpu") == torch.device("cpu")


def test_kernel_modules_import_and_nothing_builds_without_nvcc(monkeypatch):
    """Importing the kernel modules builds nothing; a build without nvcc
    raises instead of falling back."""
    env = {**os.environ, "PATH": "/nonexistent"}
    code = ("import seqrec_tpu_torch.ops.cuda.gather, seqrec_tpu_torch.ops.cuda.gru\n"
            "import seqrec_tpu_torch.ops.cuda.head, seqrec_tpu_torch.train.trainer\n"
            "import seqrec_tpu_torch.ops.cuda.attention, seqrec_tpu_torch.ops.cuda.lstm\n"
            "from seqrec_tpu_torch.ops import _build\n"
            "assert not _build._LIBS\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os, "access", lambda path, mode: False)
    monkeypatch.setattr(_build, "lib_path", lambda name: Path("/nonexistent/lib.so"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(["gather"])


def test_build_flags_target_sm90a_and_sources_exist():
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    for name in _build.SOURCES:
        assert (_build.CSRC_DIR / f"{name}.cu").is_file()
        assert _build.lib_path(name).parent == _build.BUILD_DIR


def test_configs_load_unchanged_into_the_port_config():
    for path in sorted((ROOT / "configs").glob("*.json")):
        cfg = RunConfig.load(str(path))
        assert RunConfig.from_json(cfg.to_json()) == cfg
    cfg = RunConfig.load(str(ROOT / "configs/ml1m_gru4rec.json"))
    assert (cfg.model.arch, cfg.model.embed_dim, cfg.model.hidden,
            cfg.model.compute_dtype, cfg.data.max_len) == ("gru4rec", 128, 128,
                                                         "bfloat16", 200)
    cfg = cfg.apply_overrides(["model.use_pallas=false", "--data.max_len=12"])
    assert cfg.model.use_pallas is False and cfg.data.max_len == 12
    with pytest.raises(KeyError, match="nope"):
        cfg.apply_overrides(["model.nope=1"])


def test_recommend_cli_runs_end_to_end_on_cpu(tmp_path):
    overrides = ["model.embed_dim=8", "model.compute_dtype=float32",
                 "model.loss=full_softmax", "data.max_len=6"]
    cfg = RunConfig().apply_overrides(overrides)
    model = build_model(cfg.model, 25, num_users=3, device="cpu")
    params = random_params(model, seed=11)
    params["params"]["output_bias"] = np.linspace(-1, 1, 25, dtype=np.float32)
    weights = tmp_path / "params.npz"
    save_npz(str(weights), params)
    rng = np.random.default_rng(0)
    hist = [{"user": i % 4, "history": rng.integers(1, 25, size=n).tolist()}
            for i, n in enumerate([3, 0, 9, 1, 6])]
    src = tmp_path / "hist.jsonl"
    src.write_text("".join(json.dumps(h) + "\n" for h in hist))

    cmd = [sys.executable, "-m", "seqrec_tpu_torch", "recommend",
           "--weights", str(weights), "--input", str(src), "--k", "4",
           "--batch_size", "2", "--device", "cpu"]
    for ov in overrides:
        cmd += ["--set", ov]
    r = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    got = [json.loads(line) for line in r.stdout.splitlines()]

    model.load_state_dict(flax_to_state_dict(params))
    want = list(recommend(model, hist, k=4, batch_size=2, max_len=6))
    assert got == json.loads(json.dumps(want))
    assert [g["user"] for g in got] == [h["user"] for h in hist]
    for g, h in zip(got, hist):
        assert len(g["items"]) == 4 and not set(g["items"]) & set(h["history"])


def test_recommend_cli_defaults_to_cuda(tmp_path, monkeypatch):
    from seqrec_tpu_torch import cli

    model = build_model(ModelConfig(embed_dim=8), 9, device="cpu")
    weights = tmp_path / "params.npz"
    save_npz(str(weights), random_params(model, seed=0))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["recommend", "--weights", str(weights),
                  "--set", "model.embed_dim=8", "--input", os.devnull])
