"""The PyTorch port stands alone: importing it loads neither JAX nor the
JAX package, no module of it imports either, and kernel toolchains are
only touched on first use (the CPU test hosts have no nvcc or triton)."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

SRC = Path(__file__).resolve().parents[1] / "src"
PORT = SRC / "repro_torch"
MODULES = sorted(PORT.rglob("*.py"))


def test_import_leaves_jax_and_repro_out_of_sys_modules():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.api, repro_torch.core.vb\n"
        "import repro_torch.kernels.merge_topics.ops\n"
        "import repro_torch.kernels.vb_estep.ops\n"
        "import repro_torch.kernels.flash_attention.ops\n"
        "import repro_torch.kernels.decode_attention.ops\n"
        "import repro_torch.kernels.slstm_scan.ops\n"
        "import repro_torch.models.model, repro_torch.models.convert\n"
        "import repro_torch.models.recurrent\n"
        "import repro_torch.launch.serve, repro_torch.data.lm\n"
        "import repro_torch.serve, repro_torch.ingest, "
        "repro_torch.obs.profile\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.') "
        "or m == 'triton')\n"
        "print(','.join(bad))\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "", f"loaded: {out.stdout.strip()}"


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", MODULES,
                         ids=[str(p.relative_to(SRC)) for p in MODULES])
def test_no_module_imports_jax_or_repro(path):
    for name in _imports(path):
        root = name.split(".")[0]
        assert root not in ("jax", "jaxlib", "repro"), \
            f"{path.relative_to(SRC)} imports {name}"


def test_port_mirrors_the_jax_package_layout():
    for sub in ("configs", "core", "data", "obs", "testing", "kernels",
                "api", "models", "launch", "serve", "ingest"):
        assert (PORT / sub / "__init__.py").is_file()
    assert sorted(p.name for p in (PORT / "kernels" / "csrc").glob("*.cu")) \
        == ["decode_attention.cu", "flash_attention.cu", "gibbs_sweep.cu",
            "merge_topics.cu", "slstm_scan.cu", "vb_estep.cu"]


def test_every_c_entry_point_has_a_declared_signature():
    """Each ``extern "C"`` function the ctypes loader declares exists in
    the CUDA sources, and returns its launch status."""
    from repro_torch.kernels import common
    text = "".join(p.read_text() for p in common.CSRC_DIR.glob("*.cu"))
    for name in [*common._SIGNATURES, "mlego_error_string"]:
        assert f" {name}(" in text, name
    assert text.count("return cudaGetLastError();") \
        + text.count("return (int)cudaGetLastError();") >= 3


def test_every_c_entry_point_takes_its_declared_argument_count():
    """ctypes passes exactly the arguments ``_SIGNATURES`` declares, so
    each must match its C definition's parameter list."""
    import re
    from repro_torch.kernels import common
    text = "".join(p.read_text() for p in common.CSRC_DIR.glob("*.cu"))
    defs = {name: params for name, params in re.findall(
        r"^int (mlego_\w+)\(([^)]*)\)\s*\{", text, flags=re.M)}
    assert set(defs) == set(common._SIGNATURES)
    for name, params in defs.items():
        assert len(params.split(",")) == len(common._SIGNATURES[name]), name


def test_library_name_tracks_the_sources(tmp_path, monkeypatch):
    from repro_torch.kernels import common
    before = common.library_path()
    assert before.parent == common.BUILD_DIR
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for pattern in ("*.cu", "*.cuh"):
        for p in common.CSRC_DIR.glob(pattern):
            (csrc / p.name).write_text(p.read_text())
    monkeypatch.setattr(common, "CSRC_DIR", csrc)
    assert common.library_path() == before
    (csrc / "mma_ptx.cuh").write_text("// changed\n")
    header_changed = common.library_path()
    assert header_changed != before
    (csrc / "vb_estep.cu").write_text("// changed\n")
    assert common.library_path() not in (before, header_changed)


def test_cpu_device_resolves_and_cuda_raises_without_a_card():
    from repro_torch.kernels.common import (DeviceUnavailableError,
                                            resolve_device)
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(DeviceUnavailableError):
        resolve_device(None)
    with pytest.raises(DeviceUnavailableError):
        resolve_device("cuda")


def test_kernel_error_is_not_a_device_loss():
    from repro_torch.core.errors import (DeviceLostError,
                                         PermanentExecutionError)
    from repro_torch.kernels.common import KernelError
    assert issubclass(KernelError, PermanentExecutionError)
    assert not issubclass(KernelError, DeviceLostError)


def test_device_guard_maps_cuda_runtime_errors_only():
    from repro_torch.api.backend import HostBackend
    from repro_torch.core.errors import DeviceLostError
    from repro_torch.kernels.common import KernelError
    b = HostBackend()
    with pytest.raises(DeviceLostError):
        with b._device_guard():
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")
    with pytest.raises(DeviceLostError):
        with b._device_guard():
            raise RuntimeError("CUDA error: an illegal memory access")
    with pytest.raises(KernelError):
        with b._device_guard():
            raise KernelError("vb_estep launch failed: CUDA error 1")
    with pytest.raises(RuntimeError, match="shape"):
        with b._device_guard():
            raise RuntimeError("shape mismatch")
