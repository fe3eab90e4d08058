"""Boundaries of the port: no JAX, CUDA by default, kernels documented.

  * No module of ``src/repro_torch`` and not ``chip_smoke.py`` imports
    ``jax`` or the JAX package ``repro`` (an AST scan).
  * Entry points run on ``cuda`` unless ``device="cpu"`` is passed, and
    raise when no CUDA device is present.
  * ``chip_smoke.py`` exits non-zero and prints no result without a card,
    and when it stands alone outside a checkout.
  * Every CUDA source carries the note: what it replaces, what bounds it,
    what its design does about that.
"""
import ast
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _is_forbidden(name: str) -> bool:
    root = name.split(".")[0]
    return root in ("jax", "jaxlib", "repro")


def test_port_and_chip_smoke_import_neither_jax_nor_repro():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    assert {PORT / "serve" / "pages.py", PORT / "serve" / "decode.py",
            PORT / "sweep" / "executor.py", PORT / "guard" / "policy.py",
            PORT / "launch" / "sweep.py", PORT / "guard" / "monitors.py",
            PORT / "guard" / "scenario.py",
            PORT / "runtime" / "bridge.py"} <= set(files)
    bad = [(str(f.relative_to(ROOT)), m) for f in files
           for m in _imported_modules(f) if _is_forbidden(m)]
    assert not bad, bad


def test_port_imports_in_a_process_without_jax():
    code = ("import sys, repro_torch, repro_torch.serve, repro_torch.convert,"
            " repro_torch.configs, repro_torch.train, repro_torch.optim, "
            "repro_torch.launch.train, repro_torch.serve.pages, "
            "repro_torch.serve.decode, repro_torch.sweep, repro_torch.guard, "
            "repro_torch.launch.sweep, repro_torch.guard.scenario, "
            "repro_torch.runtime.bridge; "
            "assert 'jax' not in sys.modules and 'repro' not in sys.modules")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    from repro_torch.configs import get_config
    from repro_torch.core import preset
    from repro_torch.convert import params_from_jax
    from repro_torch.models import lm_init
    from repro_torch.serve import PagedServeEngine, ServeEngine

    cfg = get_config("olmo-paper", "smoke")
    params = lm_init(cfg, torch.Generator().manual_seed(0), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(params, cfg, preset("bf16"))
    with pytest.raises(RuntimeError, match="CUDA"):
        PagedServeEngine(params, cfg, preset("bf16"))
    with pytest.raises(RuntimeError, match="CUDA"):
        lm_init(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_jax({}, cfg)
    from repro_torch.guard import monitor_init
    with pytest.raises(RuntimeError, match="CUDA"):
        monitor_init()
    eng = ServeEngine(params, cfg, preset("bf16"), device="cpu")
    assert eng.device.type == "cpu"


def test_tf32_is_off():
    import repro_torch  # noqa: F401
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def _run_smoke(script: Path, cwd: Path):
    return subprocess.run([sys.executable, str(script)], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    res = _run_smoke(ROOT / "chip_smoke.py", ROOT)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_chip_smoke_fails_outside_a_checkout(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    res = _run_smoke(tmp_path / "chip_smoke.py", tmp_path)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


@pytest.mark.parametrize("name", ["mx_quant.cuh", "mx_quant.cu",
                                  "mx_matmul.cu", "mx_attention.cu",
                                  "mx_small_m.cuh", "mx_gemm_sm90.cuh",
                                  "mx_matmul_bwd.cu", "mx_attention_bwd.cu"])
def test_cuda_sources_carry_their_note(name):
    text = (PORT / "kernels" / "csrc" / name).read_text()
    head = text[:text.index("#include")]
    for key in ("Replaces:", "Bound:", "Design:"):
        assert key in head, (name, key)
    assert "src/repro/kernels/" in head


def test_kernel_table_names_existing_sources_and_pallas_functions():
    from repro_torch.kernels import ops
    for name, (sources, replaces) in ops.KERNELS.items():
        assert sources[0].endswith(".cu"), sources
        for source in sources:
            assert (ROOT / source).is_file(), source
        path, line = replaces.split(":")
        lines = (ROOT / path).read_text().splitlines()
        assert lines[int(line) - 1].startswith("def "), replaces
        assert "_pallas" in lines[int(line) - 1], replaces
    assert set(ops.KERNELS) == set(ops.LAUNCHES)


def test_build_is_lazy_and_keyed_by_source_hash():
    from repro_torch.kernels import build
    assert build._LIBS == {}     # importing built and loaded nothing
    h = build.source_hash()
    assert len(h) == 16 and h == build.source_hash()
    assert str(build.BUILD_ROOT).endswith("build/repro_torch")
