"""Backend policy: which formulation a block runs on the current platform.

The single owner of that choice.  Every block that has a hand-written
kernel asks :func:`use_kernels` at trace time:

- ``cpu``: the plain XLA formulation.  A kept kernel's own tests run it
  on the CPU by passing ``interpret=True`` explicitly; no code path
  switches to the Pallas interpreter by itself.
- ``gpu``: the kept kernels, compiled for the card.
- any other platform: :class:`UnsupportedPlatform`.

The platform is the one computations are placed on: the device set by
``jax.default_device`` when there is one (so a process on the card can
run a plain CPU reference inside ``with jax.default_device(cpu)``),
otherwise JAX's default backend.

Scripts that time or check the card call :func:`require_gpu` first, so
no measurement is ever taken on the CPU by mistake, and label what they
print with :func:`card`.
"""

from __future__ import annotations

import subprocess

import jax

__all__ = ["UnsupportedPlatform", "card", "platform", "require_gpu",
           "use_kernels"]


class UnsupportedPlatform(RuntimeError):
    """The platform is neither ``cpu`` nor ``gpu``."""


def platform() -> str:
    """The platform traced computations run on (``"cpu"``, ``"gpu"``...)."""
    dev = jax.config.jax_default_device
    if dev is not None:
        return dev if isinstance(dev, str) else dev.platform
    return jax.default_backend()


def use_kernels(on: str | None = None) -> bool:
    """Whether the hand-written kernels run on platform ``on`` (default:
    :func:`platform`).  ``False`` on ``cpu``, ``True`` on ``gpu``; raises
    :class:`UnsupportedPlatform` anywhere else."""
    p = platform() if on is None else on
    if p == "cpu":
        return False
    if p == "gpu":
        return True
    raise UnsupportedPlatform(
        f"platform {p!r} is not supported: blocks run on 'cpu' (plain XLA) "
        "or 'gpu' (XLA plus the Hopper kernels)")


def require_gpu(who: str, count: int = 1) -> list:
    """JAX's devices, or ``SystemExit`` naming ``who`` unless the first
    is a GPU and there are at least ``count`` of them."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"{who}: needs a GPU, JAX found "
                         f"{devs[0].platform!r}")
    if len(devs) < count:
        raise SystemExit(f"{who}: needs {count} GPUs, found {len(devs)}")
    return devs


def card() -> str:
    """``nvidia-smi``'s name and power limit of the first card, as
    ``--query-gpu=name,power.limit --format=csv,noheader`` prints them
    (run in a child process, which stays off JAX)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"
    return out[0] if out else "nvidia-smi: no output"
