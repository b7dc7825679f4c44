"""GQA attention (the port of ``repro.models.attention``): full-sequence
``flash_attn`` for prefill and one-token ``decode_attn`` against a KV
cache.

``flash_attn`` has two routes with one contract. On a CUDA tensor it is
one ``torch.nn.functional.scaled_dot_product_attention`` call (the JAX
package computes this function in jnp, outside any Pallas kernel, so no
hand-written kernel is owed); on a CPU tensor it is
``flash_attn_plain``, the JAX package's blocked online softmax step by
step, which the tests hold against the JAX function and
``chip_smoke.py`` holds the card route against.

Both routes carry gradients for training: on the card
``scaled_dot_product_attention``'s own backward on the float32 copies,
on the CPU autograd through the plain blocked version. The JAX
package's ``flash_attn_vjp`` (its ``flash_vjp`` flag) is a jnp custom
VJP that recomputes the score blocks in the backward pass instead of
storing them: it computes the same function and the same gradients as
autograd through ``flash_attn``, so the port accepts the flag and takes
this one path for both settings (no Pallas kernel is behind it, so no
backward kernel is owed)."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.sharding.constrain import (
    as_dtensor,
    is_dtensor,
    local_shard_map,
)

NEG_INF = -1e30


def _blocks(n: int, pref: int) -> int:
    """The largest block size <= `pref` that divides `n`."""
    b = min(pref, n)
    while n % b:
        b -= 1
    return b


def attn_mask(sq: int, skv: int, *, causal: bool, q_offset: int,
              window: int, device) -> torch.Tensor | None:
    """(Sq, Skv) boolean mask, True where a query may attend: causal
    (query position ``q_offset + i`` sees keys at or before it) and a
    sliding window of `window` positions; None when nothing is masked."""
    if not causal and not window:
        return None
    qpos = q_offset + torch.arange(sq, device=device)[:, None]
    kpos = torch.arange(skv, device=device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        mask &= qpos >= kpos
    if window:
        mask &= (qpos - kpos) < window
    return mask


def flash_attn_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     causal: bool = True, q_offset: int = 0, window: int = 0,
                     q_block: int = 512, kv_block: int = 1024,
                     skip_masked_blocks: bool = False) -> torch.Tensor:
    """The blocked streaming softmax of the JAX ``flash_attn``: for each
    block of queries, a running max, sum and output over blocks of keys,
    all in float32; blocks are the largest divisors of Sq and Skv under
    `q_block` and `kv_block`. q: (B, Sq, Hq, hd); k, v: (B, Skv, Hkv,
    hd), Hq % Hkv == 0. Returns (B, Sq, Hq, hd) in q.dtype.
    `skip_masked_blocks` (plain causal attention only, as in the JAX
    function) stops each query block's loop at the last key block that
    meets its causal region: the blocks skipped add exact zeros, so the
    result is the same. (The JAX function stops at the key block that
    holds the query block's FIRST row, which drops keys that its later
    rows see when the block crosses a key-block boundary, e.g. S = 1536
    with the default blocks; ROADMAP.md §3.)"""
    B, Sq, Hq, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(hd)
    qb, kb = _blocks(Sq, q_block), _blocks(Skv, kv_block)
    # (B, Hkv, G, Sq, hd) and (B, Hkv, Skv, hd), float32
    qs = q.float().reshape(B, Sq, Hkv, G, hd).permute(0, 2, 3, 1, 4)
    ks = k.float().permute(0, 2, 1, 3)
    vs = v.float().permute(0, 2, 1, 3)
    mask = attn_mask(Sq, Skv, causal=causal, q_offset=q_offset,
                     window=window, device=q.device)
    skip = skip_masked_blocks and causal and not window and q_offset == 0 \
        and Sq == Skv
    outs = []
    for i in range(0, Sq, qb):
        qblk = qs[:, :, :, i:i + qb]
        m = torch.full((B, Hkv, G, qb), NEG_INF, device=q.device)
        l = torch.zeros((B, Hkv, G, qb), device=q.device)
        o = torch.zeros((B, Hkv, G, qb, hd), device=q.device)
        kv_end = min(Skv, ((i + qb - 1) // kb + 1) * kb) if skip else Skv
        for j in range(0, kv_end, kb):
            s = torch.einsum("bhgqd,bhkd->bhgqk", qblk,
                             ks[:, :, j:j + kb]) * scale
            if mask is not None:
                s = torch.where(mask[i:i + qb, j:j + kb], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            o = o * alpha[..., None] + torch.einsum(
                "bhgqk,bhkd->bhgqd", p, vs[:, :, j:j + kb])
            m = m_new
        outs.append(o / torch.clamp(l, min=1e-30)[..., None])
    out = torch.cat(outs, dim=3)                    # (B, Hkv, G, Sq, hd)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, hd).to(q.dtype)


def flash_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
               causal: bool = True, q_offset: int = 0, window: int = 0,
               q_block: int = 512, kv_block: int = 1024,
               skip_masked_blocks: bool = False) -> torch.Tensor:
    """GQA attention over a whole sequence, the JAX ``flash_attn``'s
    signature and result (module doc). On the card one
    ``scaled_dot_product_attention`` (``is_causal`` when the mask is
    plain causal, else an explicit causal+window mask; the blocks and
    `skip_masked_blocks` do not apply: its kernels skip masked blocks
    themselves); on the CPU ``flash_attn_plain``. DTensors run shard by
    shard (``sharded_heads``)."""
    if is_dtensor(q):
        return sharded_heads(
            lambda ql, kl, vl: flash_attn(
                ql, kl, vl, causal=causal, q_offset=q_offset, window=window,
                q_block=q_block, kv_block=kv_block,
                skip_masked_blocks=skip_masked_blocks), q, k, v, 2)
    if q.device.type == "cpu":
        return flash_attn_plain(q, k, v, causal=causal, q_offset=q_offset,
                                window=window, q_block=q_block,
                                kv_block=kv_block,
                                skip_masked_blocks=skip_masked_blocks)
    return flash_attn_sdpa(q, k, v, causal=causal, q_offset=q_offset,
                           window=window)


def sharded_heads(fn, q, k, v, head_dim: int, rows=()):
    """``fn(q, k, v, *rows)`` of GQA attention on DTensors, run on each
    rank's local shards (`rows`: per-sequence (B,) DTensors, laid out as
    the batch). A mesh dim that shards the batch of q or of k (a
    decode cache) shards both; one that shards q's heads keeps them
    sharded, and k and v's KV heads with them where they split as q's
    do, else k and v are whole on every rank and each rank picks the KV
    head of each of its query heads (head dim `head_dim` of q, 2 of k
    and v). Every other mesh dim is replicated (a partial sum is
    reduced first). The result has q's layout."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = q.device_mesh
    Hq, Hkv = q.shape[head_dim], k.shape[2]
    sizes = tuple(mesh.shape)

    def shards(t, d):
        return [isinstance(p, Shard) and p.dim == d for p in t.placements]
    q_batch, k_batch = shards(q, 0), shards(k, 0)
    q_heads = shards(q, head_dim)
    head_mesh = [i for i in range(mesh.ndim)
                 if q_heads[i] and not (q_batch[i] or k_batch[i])]
    n = 1
    for i in head_mesh:
        n *= sizes[i]
    split = n > 1 and Hkv % n == 0
    q_pl, kv_pl, row_pl = [], [], []
    for i in range(mesh.ndim):
        if q_batch[i] or k_batch[i]:
            q_pl.append(Shard(0))
            kv_pl.append(Shard(0))
            row_pl.append(Shard(0))
        elif i in head_mesh:
            q_pl.append(Shard(head_dim))
            kv_pl.append(Shard(2) if split else Replicate())
            row_pl.append(Replicate())
        else:
            q_pl.append(Replicate())
            kv_pl.append(Replicate())
            row_pl.append(Replicate())

    def local(ql, kl, vl, *rl):
        if n > 1 and not split:
            r = 0
            for i in head_mesh:
                r = r * sizes[i] + mesh.get_local_rank(i)
            hl = ql.shape[head_dim]
            idx = (r * hl + torch.arange(hl, device=ql.device)) // (Hq // Hkv)
            kl, vl = kl.index_select(2, idx), vl.index_select(2, idx)
        return fn(ql, kl, vl, *rl)

    return local_shard_map(local, mesh,
                           in_specs=(q_pl, kv_pl, kv_pl) + (row_pl,) * len(rows),
                           out_spec=q_pl)(q, k, v, *rows)


def flash_attn_sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_offset: int = 0,
                    window: int = 0) -> torch.Tensor:
    """``flash_attn``'s card route, on any device: one
    ``scaled_dot_product_attention`` (GQA by ``enable_gqa``) on float32
    copies of q, k, v, since the JAX function scores, weighs and sums
    in float32 whatever the input dtype."""
    Sq, Skv = q.shape[1], k.shape[1]
    plain_causal = causal and not window and q_offset == 0 and Sq == Skv
    mask = None if plain_causal else attn_mask(
        Sq, Skv, causal=causal, q_offset=q_offset, window=window,
        device=q.device)
    o = F.scaled_dot_product_attention(
        q.float().transpose(1, 2), k.float().transpose(1, 2),
        v.float().transpose(1, 2),
        attn_mask=mask, is_causal=plain_causal,
        enable_gqa=q.shape[2] != k.shape[2])
    return o.transpose(1, 2).to(q.dtype)


def decode_attn(q: torch.Tensor, k_cache: torch.Tensor,
                v_cache: torch.Tensor, lengths: torch.Tensor, *,
                window: int = 0) -> torch.Tensor:
    """One-token attention. q: (B, Hq, hd); caches (B, Smax, Hkv, hd);
    lengths (B,) valid lengths (the new token, already in the cache,
    sits at lengths-1). Scores, softmax and the weighted sum in
    float32; the result is cast to q.dtype. DTensors run shard by shard
    (``sharded_heads``; a cache sharded on its sequence dim is gathered
    first)."""
    if is_dtensor(q):
        lengths = as_dtensor(lengths, q.device_mesh)
        return sharded_heads(
            lambda ql, kl, vl, ll: decode_attn(ql, kl, vl, ll,
                                               window=window),
            q, k_cache, v_cache, 1, rows=(lengths,))
    B, Smax, Hkv, hd = k_cache.shape
    Hq = q.shape[1]
    G = Hq // Hkv
    qg = q.reshape(B, Hkv, G, hd).float()
    s = torch.einsum("bhgd,bkhd->bhgk", qg, k_cache.float()) \
        * (1.0 / math.sqrt(hd))
    pos = torch.arange(Smax, device=q.device)[None, :]
    mask = pos < lengths[:, None]
    if window:
        mask &= pos >= (lengths[:, None] - window)
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bkhd->bhgd", p, v_cache.float())
    return o.reshape(B, Hq, hd).to(q.dtype)


def update_kv_cache(k_cache: torch.Tensor, v_cache: torch.Tensor,
                    k_new: torch.Tensor, v_new: torch.Tensor,
                    lengths: torch.Tensor) -> None:
    """Write one new (k, v) per sequence at its current length, IN
    PLACE (the JAX package returns new caches; updating in place keeps
    one cache in device memory). k_new/v_new: (B, Hkv, hd).

    A sequence whose length has reached the cache's Smax rows writes
    nothing, as the JAX scatter drops an out-of-range index: its row
    index is clamped into range and the row already there is written
    back. No host sync, no branch on the data.

    DTensor caches (a sharded decode state) are updated shard by shard:
    the new rows and lengths are laid out as the cache's batch and head
    dims, and a rank whose shard holds a slice of the sequence dim
    (``kv_seq`` sharding) writes only the rows that fall in it."""
    if not is_dtensor(k_cache):
        _write_rows(k_cache, v_cache, k_new, v_new, lengths, 0)
        return
    from torch.distributed.tensor import Replicate, Shard

    mesh, pl = k_cache.device_mesh, k_cache.placements

    def local(t, cache_dims):
        want = [Shard(cache_dims.index(p.dim))
                if isinstance(p, Shard) and p.dim in cache_dims
                else Replicate() for p in pl]
        return as_dtensor(t, mesh).redistribute(mesh, want).to_local()

    off, rows = 0, k_cache.to_local().shape[1]
    for dim, p in enumerate(pl):
        if isinstance(p, Shard) and p.dim == 1:
            off = off * mesh.shape[dim] + mesh.get_local_rank(dim)
    off *= rows
    _write_rows(k_cache.to_local(), v_cache.to_local(),
                local(k_new, (0, 2, 3)), local(v_new, (0, 2, 3)),
                local(lengths, (0,)), off)


def _write_rows(k_cache, v_cache, k_new, v_new, lengths, off: int):
    """``update_kv_cache`` on plain tensors whose rows start at sequence
    position `off`."""
    B, rows = k_cache.shape[:2]
    b_idx = torch.arange(B, device=k_cache.device)
    at = lengths - off
    idx = at.clamp(min=0, max=rows - 1)
    keep = ((at >= 0) & (at < rows))[:, None, None]
    for cache, new in ((k_cache, k_new), (v_cache, v_new)):
        cache[b_idx, idx] = torch.where(keep, new.to(cache.dtype),
                                        cache[b_idx, idx])
