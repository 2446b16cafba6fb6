"""Sequence-sharded paged decode over per-member block slabs (counterpart
of ``repro.distributed.seqshard``).

``cache_pspec`` moves an axis to the sequence dim when neither the batch
nor the kv heads divide it.  For the paged plane that means each member
owns a contiguous slab of physical KV blocks, and a decode step attends
all of them flash-decoding style: every member computes a *partial*
softmax over the blocks it holds, and the partials merge with one
log-sum-exp combine (``softmax_combine``) instead of gathering the KV.

Opt-in, as in JAX: nothing on the serving path calls it (a pod's pool
splits its kv heads or replicates, which keeps its streams exact).  It is
plain torch over a list of slabs, numerically equivalent (f32, up to
reassociation) to ``kernels.ops.paged_decode_attention``, not
bit-identical.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30  # finite, as in the attention code: exp(NEG_INF - m) is 0


def softmax_combine(nums: list, ms: list, dens: list) -> torch.Tensor:
    """Merge per-slab partial softmaxes with one log-sum-exp rescale.

    ``nums[j]``: slab j's unnormalised weighted values (..., D); ``ms[j]``
    its row maxima (...); ``dens[j]`` its partition sums (...), each
    against slab j's keys alone, all on one device.  Returns the output
    of one softmax over the concatenated keys (up to f32
    reassociation)."""
    m_glob = torch.stack(ms).amax(dim=0)
    scales = [torch.exp(m - m_glob) for m in ms]
    total_num = sum(n * s[..., None] for n, s in zip(nums, scales))
    total_den = sum(d * s for d, s in zip(dens, scales))
    return total_num / torch.clamp(total_den, min=1e-30)[..., None]


def _local_partials(q: torch.Tensor, k_loc: torch.Tensor,
                    v_loc: torch.Tensor, block_tables: torch.Tensor,
                    cache_len: torch.Tensor, shard: int
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Partial attention of ``q`` against slab ``shard``: global block t
    lives there iff ``t // N_local == shard``.  Table entries off the
    slab, and positions past ``cache_len``, are masked, so each slab
    scores only the tokens it holds.  Returns (num (B, K, G, Dh), m (B,
    K, G), den (B, K, G)) in f32."""
    b, _, h, dh = q.shape
    n_loc, bs, kv, _ = k_loc.shape
    qf = q.float().reshape(b, kv, h // kv, dh) * dh ** -0.5
    t = block_tables.long()
    owned = (t >= shard * n_loc) & (t < (shard + 1) * n_loc)
    local = torch.clamp(t - shard * n_loc, 0, n_loc - 1)
    k_g = k_loc[local].float()  # (B, M, bs, K, Dh)
    v_g = v_loc[local].float()
    scores = torch.einsum("bkgd,bmskd->bkgms", qf, k_g)
    pos_tok = (torch.arange(t.shape[1], device=q.device)[:, None] * bs
               + torch.arange(bs, device=q.device)[None, :])
    lens = cache_len.long()[:, None, None]
    valid = owned[:, :, None] & (pos_tok[None] < lens)  # (B, M, bs)
    scores = torch.where(valid[:, None, None], scores,
                         torch.full_like(scores, NEG_INF))
    m = scores.amax(dim=(-2, -1))
    # NEG_INF is finite: an all-masked slab has m == NEG_INF and every
    # exp() == 1, so the mask gates the weights, not only the scores.
    p = torch.exp(scores - m[..., None, None]) * valid[:, None, None]
    den = p.sum(dim=(-2, -1))
    num = torch.einsum("bkgms,bmskd->bkgd", p, v_g)
    return num, m, den


def paged_decode_attention_seqshard(q: torch.Tensor, k_slabs: list,
                                    v_slabs: list,
                                    block_tables: torch.Tensor,
                                    cache_len: torch.Tensor
                                    ) -> torch.Tensor:
    """``ops.paged_decode_attention`` over a page pool split on its
    physical-block dim into equal slabs, one a member, each on its
    member's device: slab j holds global blocks ``[j * N_local, (j + 1) *
    N_local)``.  q: (B, 1, H, Dh); slabs: (N_local, bs, K, Dh);
    block_tables: (B, M) int32; cache_len: (B,) int32, all but the slabs
    on q's device, where the partials are combined.  Returns (B, 1, H,
    Dh) in q's dtype."""
    if len({tuple(k.shape) for k in k_slabs}) != 1:
        raise ValueError("the slabs must hold equal numbers of blocks")
    b, _, h, dh = q.shape
    parts = []
    for j, (kl, vl) in enumerate(zip(k_slabs, v_slabs)):
        dev = kl.device
        num, m, den = _local_partials(
            q.to(dev), kl, vl, block_tables.to(dev), cache_len.to(dev), j)
        parts.append(tuple(x.to(q.device) for x in (num, m, den)))
    nums, ms, dens = zip(*parts)
    out = softmax_combine(list(nums), list(ms), list(dens))
    return out.reshape(b, 1, h, dh).to(q.dtype)
