"""runtime/device.py: device report, GPU check, compile-cache path, and
the GPU-only tests' marker."""
import jax
import pytest

from powersystemsreliabilityassessment.runtime import device


def test_require_gpu_raises_on_cpu():
    with pytest.raises(RuntimeError, match="no GPU found"):
        device.require_gpu()


def test_jax_device_names_the_backend():
    dev = device.jax_device()
    assert dev == {"platform": "cpu", "kind": jax.devices()[0].device_kind,
                   "count": len(jax.devices())}


@pytest.mark.parametrize("line,name,limit", [
    ("NVIDIA H100 80GB HBM3, 700.00 W", "NVIDIA H100 80GB HBM3",
     "700.00 W"),
    ("NVIDIA H100 80GB HBM3, 500.00 W\n", "NVIDIA H100 80GB HBM3",
     "500.00 W"),
    ("NVIDIA H100 PCIe, [N/A]", "NVIDIA H100 PCIe", "[N/A]"),
])
def test_parse_smi_line(line, name, limit):
    assert device.parse_smi_line(line) == {"name": name,
                                           "power_limit": limit}


@pytest.mark.parametrize("line", ["", "no comma here", ", 700 W"])
def test_parse_smi_line_rejects_malformed(line):
    with pytest.raises(ValueError):
        device.parse_smi_line(line)


def test_cache_dir_follows_environment():
    assert device.cache_dir({device.CACHE_ENV: "/some/cache"}) == \
        "/some/cache"


def test_cache_dir_default_is_fixed_repo_path():
    path = device.cache_dir({})
    assert path == str(device.REPO_ROOT / ".jax_cache")
    assert path == device.cache_dir({device.CACHE_ENV: ""})


def test_enable_compile_cache_sets_jax_config(monkeypatch, tmp_path):
    monkeypatch.setenv(device.CACHE_ENV, str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    try:
        assert device.enable_compile_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_card_lines_without_nvidia_smi(monkeypatch):
    monkeypatch.setattr(device, "SMI_QUERY", ("no-such-nvidia-smi-binary",))
    assert device.card_lines() == []


@pytest.fixture
def gpu():
    """The first GPU, or a skip: decided when the test runs, never at
    import, so every test worker collects the same tests."""
    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip("needs an NVIDIA GPU (run on the card: "
                    "python -m pytest -m gpu)")
    return devs[0]


@pytest.mark.gpu
def test_require_gpu_on_card(gpu):
    dev = device.require_gpu()
    assert dev["platform"] == "gpu" and dev["kind"] == gpu.device_kind
    assert device.card_lines()
