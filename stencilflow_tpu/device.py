"""The machine the program runs on: platform, peak rates, compile cache.

Three decisions live here and nowhere else:

* which lowering a platform gets (:func:`lowering`): fused XLA
  (``backend/xla.py``, tile strategy) on ``gpu`` and ``cpu``; any other
  platform is an error;
* the published peak rates a roofline share is taken against
  (:data:`PEAKS`, keyed by JAX's ``device_kind``; an unknown kind is an
  error, never a default);
* where JAX's persistent compilation cache lives
  (:func:`enable_compile_cache`).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict

SUPPORTED_PLATFORMS = ("gpu", "cpu")


@dataclasses.dataclass(frozen=True)
class DeviceInfo:
    platform: str      # jax.devices()[0].platform
    kind: str          # jax.devices()[0].device_kind
    count: int         # len(jax.devices())


def device_info() -> DeviceInfo:
    """Platform, device kind and device count of JAX's default backend."""
    import jax
    devices = jax.devices()
    return DeviceInfo(devices[0].platform, devices[0].device_kind,
                      len(devices))


def lowering(platform: str) -> str:
    """The chain lowering for ``platform``: ``"xla"`` on gpu and cpu."""
    if platform not in SUPPORTED_PLATFORMS:
        raise RuntimeError(
            f"unsupported platform {platform!r}: chains lower through "
            f"fused XLA on {' or '.join(SUPPORTED_PLATFORMS)} only")
    return "xla"


class NoGPUError(RuntimeError):
    """A GPU was required and JAX found none."""


def require_gpu() -> DeviceInfo:
    """The default backend's devices, which must be GPUs."""
    info = device_info()
    if info.platform != "gpu":
        raise NoGPUError(
            f"no GPU found: jax.devices() holds {info.count} "
            f"{info.platform} device(s) ({info.kind})")
    return info


@dataclasses.dataclass(frozen=True)
class Peaks:
    """Published peak rates of one device."""
    name: str
    hbm_bandwidth: float     # device memory, bytes/s
    hbm_bytes: int           # device memory capacity, bytes
    fp32_flops: float        # float32 outside the tensor cores, FLOP/s
    link_bandwidth: float    # to one other device, each way, bytes/s
    source: str


H100_SXM = "NVIDIA H100 80GB HBM3"

PEAKS: Dict[str, Peaks] = {
    H100_SXM: Peaks(
        name="H100 SXM",
        hbm_bandwidth=3.35e12,
        hbm_bytes=80 * 10**9,
        fp32_flops=67e12,
        link_bandwidth=450e9,    # NVLink 900 GB/s total, all to all
        source="NVIDIA H100 Tensor Core GPU data sheet, SXM5, dense"),
}


def peaks_for(kind: str) -> Peaks:
    """Peak rates of ``device_kind`` ``kind``; unknown kinds raise."""
    try:
        return PEAKS[kind]
    except KeyError:
        raise ValueError(
            f"no peak rates for device kind {kind!r} (known: "
            f"{sorted(PEAKS)}); add its data-sheet row to device.PEAKS"
        ) from None


REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def compile_cache_dir() -> str:
    """``$JAX_COMPILATION_CACHE_DIR`` when set, else ``<repo>/.jax_cache``
    (a fixed path: the cache's key includes it, so it must not move)."""
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(REPO_ROOT, ".jax_cache"))


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at
    :func:`compile_cache_dir` and return that directory.  When the
    environment variable is set JAX already reads it, so nothing is set."""
    path = compile_cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        import jax
        jax.config.update("jax_compilation_cache_dir", path)
    return path
