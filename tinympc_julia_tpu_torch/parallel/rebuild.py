"""Static-shape straggler compaction (counterpart of the compact_members of
tinympc_julia_tpu/parallel/rebuild.py; the bucketed rebuild pipeline of that
module is not ported yet, ROADMAP.md queue 1 item 11)."""
from __future__ import annotations

import torch


def compact_members(member: torch.Tensor, slots: int):
    """Per-group compaction into a fixed number of slots, with no host sync.

    ``member`` is a (G, M) bool matrix of group membership.  Returns
    (idx (G, slots) int64 member positions in order, index-0 fill;
    counts (G,) int64; valid (G*slots,) slot-validity mask; overflow (G,)
    int32 counts of members beyond ``slots``).  Callers must drop what
    invalid slots produce: their index-0 fill re-selects position 0.

    A cumsum gives each member its slot and one scatter writes the
    positions; non-members and members past ``slots`` land in a dump column
    that is cut off, so no ``nonzero`` (a host sync) is needed."""
    G, M = member.shape
    dev = member.device
    slot = torch.cumsum(member.to(torch.int64), dim=1) - 1
    target = torch.where(member & (slot < slots), slot, slots)
    pos = torch.arange(M, device=dev).expand(G, M)
    idx = torch.zeros((G, slots + 1), dtype=torch.int64, device=dev)
    idx.scatter_(1, target, pos)
    counts = member.sum(dim=1)
    valid = (torch.arange(slots, device=dev)[None, :]
             < counts[:, None]).reshape(-1)
    overflow = torch.clamp(counts - slots, min=0).to(torch.int32)
    return idx[:, :slots], counts, valid, overflow
