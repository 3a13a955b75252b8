"""Paged KV-cache memory manager (vLLM-style block allocator).

The port of ``repro.serve.paged``. At production batch sizes the slotted
cache of ``serve.engine`` holds ``max_len`` positions per sequence. This
manager stores k/v in fixed-size blocks with a free list, so device memory
holds only what live sequences use:

    storage:  k/v  (layers, num_blocks, block_size, kv_heads, head_dim)
    mapping:  per-sequence block table (a Python list; an int32 tensor on
              the cache's device on demand)

The free list pops from its end, as the reference's does, so the same
calls give the same block tables. ``append`` writes one token at its
(block, offset) in place; ``append_prompt`` writes a prompt block by block,
in place, in the reference's order; ``gather`` takes a sequence's blocks
with ``index_select`` and gives its contiguous (layers, len, kv, hd) view
(a block-table-aware attention kernel would skip this copy; the manager's
accounting is the substance here).

The manager holds k and v only: an MLA model's cache (the latent ``ckv``
and the shared ``k_rope``) is not paged, here as in the reference.
``device=None`` means the CUDA device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import torch

from repro_torch.kernels.dispatch import resolve_device

__all__ = ["PagedKVCache"]


@dataclasses.dataclass
class _Seq:
    blocks: List[int]
    length: int = 0


class PagedKVCache:
    def __init__(
        self,
        *,
        layers: int,
        kv_heads: int,
        head_dim: int,
        num_blocks: int = 64,
        block_size: int = 16,
        dtype=torch.float32,
        device=None,
    ):
        self.layers, self.kv_heads, self.head_dim = layers, kv_heads, head_dim
        self.num_blocks, self.block_size = num_blocks, block_size
        self.device = resolve_device(device)
        shape = (layers, num_blocks, block_size, kv_heads, head_dim)
        self.k = torch.zeros(shape, dtype=dtype, device=self.device)
        self.v = torch.zeros(shape, dtype=dtype, device=self.device)
        self._free: List[int] = list(range(num_blocks))
        self._seqs: Dict[int, _Seq] = {}

    # -- accounting -----------------------------------------------------------
    @property
    def free_blocks(self) -> int:
        return len(self._free)

    def used_blocks(self) -> int:
        return self.num_blocks - len(self._free)

    def utilization(self, seq_id: int) -> float:
        s = self._seqs[seq_id]
        cap = len(s.blocks) * self.block_size
        return s.length / cap if cap else 1.0

    # -- lifecycle --------------------------------------------------------------
    def allocate(self, seq_id: int) -> None:
        if seq_id in self._seqs:
            raise KeyError(f"seq {seq_id} already allocated")
        self._seqs[seq_id] = _Seq(blocks=[])

    def free(self, seq_id: int) -> None:
        s = self._seqs.pop(seq_id)
        self._free.extend(s.blocks)

    def _grow_if_needed(self, s: _Seq, new_len: int) -> None:
        while len(s.blocks) * self.block_size < new_len:
            if not self._free:
                raise MemoryError(
                    f"paged cache OOM: {self.num_blocks} blocks all in use"
                )
            s.blocks.append(self._free.pop())

    # -- writes -----------------------------------------------------------------
    def append(self, seq_id: int, k_tok: torch.Tensor, v_tok: torch.Tensor) -> None:
        """Append one token. k_tok/v_tok: (layers, kv_heads, head_dim)."""
        s = self._seqs[seq_id]
        pos = s.length
        self._grow_if_needed(s, pos + 1)
        block = s.blocks[pos // self.block_size]
        off = pos % self.block_size
        self.k[:, block, off] = k_tok.to(self.k.dtype)
        self.v[:, block, off] = v_tok.to(self.v.dtype)
        s.length = pos + 1

    def append_prompt(self, seq_id: int, k_seq: torch.Tensor, v_seq: torch.Tensor) -> None:
        """Bulk prefill. k_seq/v_seq: (layers, T, kv_heads, head_dim)."""
        t = k_seq.shape[1]
        s = self._seqs[seq_id]
        start = s.length
        self._grow_if_needed(s, start + t)
        done = 0                                # one slice write a block
        while done < t:
            pos = start + done
            block = s.blocks[pos // self.block_size]
            off = pos % self.block_size
            n = min(self.block_size - off, t - done)
            self.k[:, block, off:off + n] = k_seq[:, done:done + n].to(self.k.dtype)
            self.v[:, block, off:off + n] = v_seq[:, done:done + n].to(self.v.dtype)
            done += n
        s.length = start + t

    # -- reads ------------------------------------------------------------------
    def block_table(self, seq_id: int) -> torch.Tensor:
        return torch.tensor(self._seqs[seq_id].blocks, dtype=torch.int32, device=self.device)

    def length(self, seq_id: int) -> int:
        return self._seqs[seq_id].length

    def gather(self, seq_id: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Contiguous (layers, len, kv_heads, head_dim) view of a sequence."""
        s = self._seqs[seq_id]
        if not s.blocks:
            empty = torch.zeros((self.layers, 0, self.kv_heads, self.head_dim),
                                dtype=self.k.dtype, device=self.device)
            return empty, empty
        idx = self.block_table(seq_id)
        k = self.k.index_select(1, idx)         # (L, nb, bs, kv, hd)
        v = self.v.index_select(1, idx)
        flat = lambda x: x.reshape(self.layers, -1, self.kv_heads, self.head_dim)[:, :s.length]  # noqa: E731
        return flat(k), flat(v)
