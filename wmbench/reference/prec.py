"""The precision a reference computation runs in.

`f64` is the plain reference: every product, sum and spectrum in float64.
The controls are the same code one step below the float32 that the
configurations state:

* `tf32`: float32 with TensorFloat-32 matrix products (the step below
  float32 with TF32 off, which is what the port runs: its device module
  keeps matmul precision at "highest");
* `bf16`: float32 arithmetic with every stage's output rounded to
  bfloat16, for float32 work that TF32 does not touch (spectra, element
  arithmetic, sums).
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import torch

MODES = ("f64", "tf32", "bf16")


@dataclass(frozen=True)
class Prec:
    mode: str = "f64"

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError("precision %r is not one of %s"
                             % (self.mode, MODES))

    @property
    def dtype(self) -> torch.dtype:
        return torch.float64 if self.mode == "f64" else torch.float32

    def q(self, x: torch.Tensor) -> torch.Tensor:
        """A stage's output as this precision keeps it."""
        if self.mode != "bf16":
            return x
        if x.is_complex():
            return torch.complex(self.q(x.real), self.q(x.imag))
        return x.to(torch.bfloat16).to(x.dtype)

    @contextlib.contextmanager
    def matmul(self):
        """Matrix products inside run in TF32 in the `tf32` mode."""
        old = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = self.mode == "tf32"
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32 = old
