"""Mode-grouped storage for per-node matrix stacks.

On Markovian problems the per-node matrix stacks (sqrt(Q_j), sqrt(R_j),
sqrt(P_l), ...) hold only a handful of distinct matrices, one per Markov
mode. Mode-grouped storage computes ALL modes with one dense
[num_nodes, b] @ [b, M*a] matmul, which reads only the vectors, and then
selects each node's mode (counterpart of :mod:`raocp_tpu.core.modal`).
"""

import dataclasses
from typing import Optional

import numpy as np
import torch

__all__ = ["ModalMatrix", "from_dense_stack", "upload", "MODAL_MAX_MODES"]

# use mode-grouping when the number of distinct matrices is at most this
MODAL_MAX_MODES = 16


@dataclasses.dataclass(frozen=True)
class ModalMatrix:
    """Either a dense per-node stack or (modes, index) grouped storage."""

    dense_m: Optional[torch.Tensor]   # [N, a, b] or None
    modes: Optional[torch.Tensor]     # [M, a, b] or None
    idx: Optional[torch.Tensor]       # [N] int64 mode index, or None

    @property
    def num_rows(self) -> int:
        if self.dense_m is not None:
            return self.dense_m.shape[0]
        return self.idx.shape[0]

    def matvec(self, x):
        """Per-row M[i] @ x[i]; x: [..., N, b] -> [..., N, a]."""
        if self.dense_m is not None:
            return torch.einsum("jab,...jb->...ja", self.dense_m, x)
        if self.modes.shape[0] == 1:
            return x @ self.modes[0].T
        all_modes = torch.einsum("...jb,mab->...jma", x,
                                 self.modes)                # [..., N, M, a]
        return _select(all_modes, self.idx)

    def rmatvec(self, v):
        """Per-row M[i]' @ v[i]; v: [..., N, a] -> [..., N, b]."""
        if self.dense_m is not None:
            return torch.einsum("jab,...ja->...jb", self.dense_m, v)
        if self.modes.shape[0] == 1:
            return v @ self.modes[0]
        all_modes = torch.einsum("...ja,mab->...jmb", v,
                                 self.modes)                # [..., N, M, b]
        return _select(all_modes, self.idx)

    def slice_rows(self, a: int, b: int) -> "ModalMatrix":
        """View of rows [a, b): modes stay shared, only the index slices."""
        if self.dense_m is not None:
            return ModalMatrix(dense_m=self.dense_m[a:b], modes=None,
                               idx=None)
        return ModalMatrix(dense_m=None, modes=self.modes,
                           idx=self.idx[a:b])

    def dense(self):
        """Materialise the [N, a, b] stack (for tests/inspection)."""
        if self.dense_m is not None:
            return self.dense_m
        return self.modes[self.idx]


def _select(all_modes, idx):
    """rows[..., i, :] = all_modes[..., i, idx[i], :] for all_modes
    [..., N, M, a]."""
    index = idx[:, None, None].expand(
        tuple(all_modes.shape[:-3]) + (-1, 1, all_modes.shape[-1]))
    return torch.gather(all_modes, -2, index)[..., 0, :]


def upload(arr, dtype=None, device="cuda") -> torch.Tensor:
    """A C-contiguous tensor of ``arr`` on ``device`` (NumPy results such
    as stacked transposes can be strided; the kernels take plain row-major
    memory)."""
    return torch.as_tensor(np.ascontiguousarray(arr), dtype=dtype,
                           device=device)


def from_dense_stack(stack: np.ndarray, dtype, device) -> ModalMatrix:
    """Build mode-grouped storage when few distinct matrices exist."""
    n_rows = stack.shape[0]
    seen = {}
    idx = np.zeros(n_rows, dtype=np.int64)
    modes = []
    for i in range(n_rows):
        key = stack[i].tobytes()
        if key not in seen:
            seen[key] = len(modes)
            modes.append(stack[i])
        idx[i] = seen[key]
        if len(modes) > MODAL_MAX_MODES:
            return ModalMatrix(
                dense_m=upload(stack, dtype, device),
                modes=None, idx=None)
    return ModalMatrix(
        dense_m=None,
        modes=upload(np.stack(modes), dtype, device),
        idx=upload(idx, device=device))
