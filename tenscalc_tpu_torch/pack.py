"""Variable packing: flatten a list of named tensor variables into one
primal vector u and back (port of ``tenscalc_tpu/pack.py``).  Both
directions use C (row-major) order, as the JAX package does."""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from .expr import Variable


class Packing:
    """Mapping between {name: tensor} environments and a packed vector."""

    def __init__(self, variables: Sequence[Variable]):
        self.names: List[str] = [v.name for v in variables]
        if len(set(self.names)) != len(self.names):
            raise ValueError(f"duplicate variable names: {self.names}")
        self.shapes: List[Tuple[int, ...]] = [v.shape for v in variables]
        self.sizes: List[int] = [int(np.prod(s)) if s else 1 for s in self.shapes]
        self.offsets: List[int] = [int(o) for o in np.cumsum([0] + self.sizes[:-1])]
        self.total: int = int(sum(self.sizes))

    def pack(self, env: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Concatenate the raveled variables of ``env`` (1-D result)."""
        parts = []
        for name, shape in zip(self.names, self.shapes):
            v = env[name]
            if tuple(v.shape) != shape:
                raise ValueError(
                    f"variable {name!r}: expected shape {shape}, got {tuple(v.shape)}"
                )
            parts.append(torch.ravel(v))
        return torch.cat(parts)

    def unpack(self, u: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Views of the 1-D packed vector ``u``, one per variable."""
        return {
            name: torch.reshape(u[off: off + size], shape)
            for name, shape, size, off in zip(
                self.names, self.shapes, self.sizes, self.offsets
            )
        }

    def slice_of(self, name: str) -> slice:
        i = self.names.index(name)
        return slice(self.offsets[i], self.offsets[i] + self.sizes[i])
