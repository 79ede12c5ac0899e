"""The platform decision, the peak table and the compile-cache placement
(stencilflow_tpu/device.py)."""
import os

import pytest

from stencilflow_tpu import device


@pytest.mark.parametrize("platform", ["gpu", "cpu"])
def test_gpu_and_cpu_lower_through_xla(platform):
    assert device.lowering(platform) == "xla"


@pytest.mark.parametrize("platform", ["rocm", "METAL", "neuron", ""])
def test_other_platforms_raise(platform):
    with pytest.raises(RuntimeError, match="unsupported platform"):
        device.lowering(platform)


def test_device_info_reports_the_test_backend():
    info = device.device_info()
    assert info.platform == "cpu"
    assert info.count == 8          # conftest's virtual mesh
    assert isinstance(info.kind, str) and info.kind


def test_require_gpu_raises_on_cpu():
    with pytest.raises(device.NoGPUError, match="no GPU found"):
        device.require_gpu()


def test_h100_row_from_the_data_sheet():
    pk = device.peaks_for("NVIDIA H100 80GB HBM3")
    assert pk is device.PEAKS[device.H100_SXM]
    assert pk.hbm_bandwidth == 3.35e12
    assert pk.hbm_bytes == 80 * 10**9
    assert pk.fp32_flops == 67e12
    assert pk.link_bandwidth == 450e9
    assert "data sheet" in pk.source


@pytest.mark.parametrize("kind", ["cpu", "AMD Instinct MI300X",
                                  "NVIDIA A100-SXM4-80GB",
                                  "NVIDIA H100 PCIe", ""])
def test_unknown_device_kind_raises(kind):
    with pytest.raises(ValueError, match="no peak rates"):
        device.peaks_for(kind)


def test_roofline_of_an_unknown_device_raises():
    """Anything priced against a device looks its row up: an unknown
    kind is an error, never a default."""
    import stencilflow_tpu as sft
    from stencilflow_tpu.report import Report
    from stencilflow_tpu.synthesize import jacobi
    p = sft.parse_program(jacobi(3, 8, iterations=1))
    with pytest.raises(ValueError, match="no peak rates"):
        Report.build(p, hw=device.peaks_for("cpu"))
    assert Report.build(p).hw.name == "H100 SXM"


def test_cli_report_device_kind(tmp_path, capsys):
    import json

    from stencilflow_tpu.cli import main as cli_main
    from stencilflow_tpu.synthesize import jacobi
    path = tmp_path / "p.json"
    path.write_text(json.dumps(jacobi(3, 8, iterations=1)))
    assert cli_main(["report", str(path), "--json",
                     "--device-kind", device.H100_SXM]) == 0
    assert json.loads(capsys.readouterr().out)["hardware"] == "H100 SXM"
    with pytest.raises(SystemExit):
        cli_main(["report", str(path), "--device-kind", "NVIDIA H100 PCIe"])


def test_cache_dir_honours_the_environment(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert device.compile_cache_dir() == str(tmp_path)


def test_cache_dir_defaults_inside_the_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert device.compile_cache_dir() == os.path.join(repo, ".jax_cache")


def test_enable_compile_cache_sets_nothing_when_env_is_set(monkeypatch,
                                                          tmp_path):
    import jax
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert device.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_enable_compile_cache_sets_the_fixed_default(monkeypatch):
    import jax
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        path = device.enable_compile_cache()
        assert path == device.compile_cache_dir()
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
