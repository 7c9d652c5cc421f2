"""Runtime error checking — the ``gpuErrchk`` analog.

The counterpart of ``gridcodegenerator_tpu/utils/errors.py``. The reference
wraps every CUDA call in ``gpuErrchk`` and aborts with file/line context on
failure; the port's kernel wrappers check each launch's CUDA error already
(``ops/cuda/build.py:check``). What is left to check is silent NaN/Inf
propagation and out-of-range states:

* :func:`checked` — wrap any function so non-finite outputs raise
  ``FloatingPointError`` with its name and the offending output's index;
* :func:`assert_finite` — inline guard that returns its input;
* :func:`check_joint_limits` — q against the model's joint limits.

On a CUDA tensor the finiteness check reads one flag back to the host, so
it synchronizes with the card: the error raises at the call, not at a later
synchronization.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def assert_finite(x: torch.Tensor, name: str = "array") -> torch.Tensor:
    """Return ``x``; raise ``FloatingPointError`` if any entry is NaN or
    Inf."""
    if not bool(torch.isfinite(torch.as_tensor(x)).all()):
        raise FloatingPointError(
            f"non-finite values in {name} (NaN/Inf propagated through "
            "the kernel — check inputs and integration step)")
    return x


def _leaves(out):
    """The outputs' leaves in the JAX pytree order: tuples and lists in
    order, dicts by sorted key, None dropped."""
    if out is None:
        return []
    if isinstance(out, (tuple, list)):
        return [leaf for o in out for leaf in _leaves(o)]
    if isinstance(out, dict):
        return [leaf for k in sorted(out) for leaf in _leaves(out[k])]
    return [out]


def checked(fn, name: str = None):
    """Wrap ``fn`` so every output is finite-checked (gpuErrchk analog)."""
    label = name or getattr(fn, "__name__", "kernel")

    @functools.wraps(fn)
    def wrapper(*args, **kw):
        out = fn(*args, **kw)
        for k, leaf in enumerate(_leaves(out)):
            assert_finite(leaf, f"{label} output {k}")
        return out

    return wrapper


def check_joint_limits(model, q, batch_major: bool = True) -> np.ndarray:
    """Host-side check of q against the model's joint limits.

    Returns a boolean numpy array (one per sample) — True where ALL joints
    are within [lower, upper]; unbounded joints (±inf) always pass.
    """
    if isinstance(q, torch.Tensor):
        q = q.detach().cpu().numpy()
    qn = np.asarray(q)
    if qn.ndim == 1:
        qn = qn[None]
    elif not batch_major:
        qn = qn.T
    lims = model.joint_limits.detach().cpu().numpy()
    lo, hi = lims[:, 0], lims[:, 1]
    npos = qn.shape[-1]
    if lims.shape[0] != npos:  # floating base: skip the 7 base coordinates
        off = npos - lims.shape[0]
        qn = qn[:, off:]
    return np.all((qn >= lo) & (qn <= hi), axis=-1)
