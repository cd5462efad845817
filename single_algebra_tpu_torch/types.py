"""Core enums, dtype policy and matmul precision policy of the torch port.

Counterpart of ``single_algebra_tpu/types.py``: the same ``Direction``,
``PowerIterationNormalizer`` and ``SVDMethod`` (so builder code reads the
same in both packages) and the f32/f64 value policy.

The JAX package runs every dot at ``Precision.HIGHEST`` (its
``MATMUL_PRECISION``), whatever the caller's global settings. The port's
equivalent is :func:`precision_policy`, a context manager that every
public fit, transform and product entry point enters: float32 matrix
products run in full IEEE float32, never TF32, for the length of the
call, and the caller's flags are restored on exit. The f32 Gram tier,
the projection and the randomized solve all assume it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import enum

import numpy as np
import torch


class Direction(enum.Enum):
    """Row/column axis selector (reference: single_utilities Direction)."""

    ROW = "row"
    COLUMN = "column"


class PowerIterationNormalizer(enum.Enum):
    """Stabilization applied between power iterations in randomized SVD."""

    QR = "qr"
    LU = "lu"
    NONE = "none"


@dataclasses.dataclass(frozen=True)
class SVDMethod:
    """SVD algorithm selection; the default, as in the reference, is
    Lanczos. Use the constructors :meth:`lanczos` and :meth:`random`."""

    kind: str = "lanczos"  # "lanczos" | "random"
    n_oversamples: int = 10
    n_power_iterations: int = 7
    normalizer: PowerIterationNormalizer = PowerIterationNormalizer.QR

    @classmethod
    def lanczos(cls) -> "SVDMethod":
        return cls(kind="lanczos")

    @classmethod
    def random(
        cls,
        n_oversamples: int = 10,
        n_power_iterations: int = 7,
        normalizer: PowerIterationNormalizer = PowerIterationNormalizer.QR,
    ) -> "SVDMethod":
        return cls(
            kind="random",
            n_oversamples=n_oversamples,
            n_power_iterations=n_power_iterations,
            normalizer=normalizer,
        )

    @property
    def is_random(self) -> bool:
        return self.kind == "random"


# ---------------------------------------------------------------------------
# dtype and precision policy
# ---------------------------------------------------------------------------


def set_precision_policy() -> None:
    """Full-float32 products everywhere: TF32 off for cuBLAS and cuDNN,
    ``"highest"`` float32 matmul precision (the port's counterpart of
    ``MATMUL_PRECISION = HIGHEST``), and no reduced-precision (bf16)
    accumulation inside bf16 products: the densified engine's bf16 x bf16
    products accumulate in float32, as ``preferred_element_type=float32``
    does in the JAX package."""

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


@contextlib.contextmanager
def precision_policy():
    """Hold :func:`set_precision_policy` for the length of a ``with``
    block (or of a call, as a decorator: ``@precision_policy()``), then
    put back the caller's TF32, bf16-reduction and float32-precision
    flags, whatever they were."""

    mm = torch.backends.cuda.matmul
    saved = (
        torch.get_float32_matmul_precision(),
        mm.allow_tf32,
        mm.allow_bf16_reduced_precision_reduction,
        torch.backends.cudnn.allow_tf32,
    )
    set_precision_policy()
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(saved[0])
        mm.allow_tf32 = saved[1]
        mm.allow_bf16_reduced_precision_reduction = saved[2]
        torch.backends.cudnn.allow_tf32 = saved[3]


_SUPPORTED_FLOATS = (np.float32, np.float64)


def canonical_float_dtype(dtype) -> np.dtype:
    """Validate and canonicalize a floating dtype (f32/f64 policy). Unlike
    the JAX package, float64 needs no mode switch in torch."""

    dt = np.dtype(dtype)
    if dt.type not in _SUPPORTED_FLOATS:
        raise TypeError(
            f"single_algebra_tpu_torch supports float32/float64 values, got {dt}"
        )
    return dt


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a numpy float dtype."""

    return {np.float32: torch.float32, np.float64: torch.float64}[
        np.dtype(dtype).type
    ]
