"""Shared model pieces (the port of ``repro.models.common``): norms,
RoPE, sinusoidal positions, embeddings, parameter counts. Functions on
tensors, same layouts and the same float32 islands as the JAX
package."""
from __future__ import annotations

import math

import torch


def apply_norm(p: dict, x: torch.Tensor, kind: str, eps: float) -> torch.Tensor:
    """RMSNorm or LayerNorm computed in float32, cast back to x.dtype.
    `p` holds float32 ``scale`` (and ``bias`` for layernorm)."""
    xf = x.float()
    if kind == "layernorm":
        mu = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    else:
        ms = xf.square().mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * p["scale"]
    return y.to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions broadcastable to (..., S). Rotates
    the interleaved pairs ``x[..., 0::2]``/``x[..., 1::2]`` (not the
    rotate-half convention), in float32."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)
    angles = positions[..., None].float() * freqs       # (..., S, hd/2)
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1 = x[..., 0::2].float()
    x2 = x[..., 1::2].float()
    out = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


def sinusoidal_pos_emb(length: int, dim: int) -> torch.Tensor:
    """The (length, dim) float32 table of positions 0..length-1: sines
    of the first dim/2 frequencies, then their cosines, computed in
    float64 on the host as the JAX package's table is."""
    pos = torch.arange(length, dtype=torch.float64)[:, None]
    i = torch.arange(dim // 2, dtype=torch.float64)[None, :]
    angle = pos / torch.pow(torch.tensor(10000.0, dtype=torch.float64),
                            2 * i / dim)
    return torch.cat([torch.sin(angle), torch.cos(angle)],
                     dim=-1).float()


def sin_pos(positions: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoidal embedding of `positions` (...,) -> (..., dim) in
    float32: sines of the first dim/2 frequencies, then their cosines,
    as the JAX ``sin_pos`` computes it (cast to the working dtype at
    use)."""
    i = torch.arange(dim // 2, dtype=torch.float32, device=positions.device)
    angle = positions[..., None].float() / torch.pow(
        torch.tensor(10000.0, device=positions.device), 2 * i / dim)
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)


def pad_vocab(vocab: int, multiple: int = 256) -> int:
    return ((vocab + multiple - 1) // multiple) * multiple


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor,
                 dtype: torch.dtype) -> torch.Tensor:
    """The rows of `table` (in `dtype`) at `tokens`. A DTensor table is
    gathered whole (``force_replicate``, counted as "embed") and each
    rank looks up its own tokens locally: DTensor's rules for a lookup
    in a vocab-sharded table, and for its backward, do not hold in every
    torch release the port runs on."""
    from repro_torch.sharding.constrain import as_dtensor, \
        force_replicate, is_dtensor, local_shard_map

    if not is_dtensor(table):
        return table.to(dtype)[tokens]
    mesh = table.device_mesh
    tokens = as_dtensor(tokens, mesh)
    full = force_replicate(table.to(dtype), "embed")
    return local_shard_map(lambda t, k: t[k], mesh,
                           in_specs=(full.placements, tokens.placements),
                           out_spec=tokens.placements)(full, tokens)


# ---------------------------------------------------------------- losses

def _mask_padded(logits: torch.Tensor, vocab: int) -> torch.Tensor:
    """Add -1e9 to the logits of the padded vocab entries."""
    pad = logits.shape[-1] - vocab
    if not pad:
        return logits
    mask = torch.cat([torch.zeros(vocab, device=logits.device),
                      torch.full((pad,), -1e9, device=logits.device)])
    return logits + mask


def _one_vocab_split(logits):
    """A DTensor's (tokens, V) logits split or summed over at most one
    mesh dim on V: DTensor's gather masks the index once per such mesh
    dim into one buffer, which fails for two (fake tensors raise, real
    ones conflict). Logits partial or sharded on V over several mesh
    dims (a contraction over an FSDP-sharded model dim, as zero3's rules
    give on the multi-pod mesh) keep that on the last of them and are
    reduced or gathered on the others (``FORCED["xent_vocab"]``)."""
    from repro_torch.sharding.constrain import FORCED, is_dtensor

    if not is_dtensor(logits):
        return logits
    from torch.distributed.tensor import Partial, Replicate, Shard

    d = logits.ndim - 1
    split = [j for j, p in enumerate(logits.placements)
             if isinstance(p, Partial) or (isinstance(p, Shard)
                                           and p.dim == d)]
    if len(split) < 2:
        return logits
    FORCED["xent_vocab"] += 1
    keep = split[-1]
    placements = [Replicate() if j in split and j != keep
                  else Shard(d) if j == keep else p
                  for j, p in enumerate(logits.placements)]
    return logits.redistribute(logits.device_mesh, placements)


def _token_xent(logits: torch.Tensor, labels: torch.Tensor,
                vocab: int) -> torch.Tensor:
    """(tokens, 1) float32: each token's logsumexp less its gold logit.
    The gold logits are gathered from a (tokens, V) view and stay
    (tokens, 1) until the subtraction: DTensor's gather from
    vocab-sharded logits leaves a masked partial sum that must be
    reduced at the index's shape."""
    logits = _mask_padded(logits.float(), vocab)
    logits = _one_vocab_split(logits.reshape(-1, logits.shape[-1]))
    logz = torch.logsumexp(logits, dim=-1, keepdim=True)
    gold = torch.gather(logits, 1, labels.reshape(-1, 1).long())
    return logz - gold


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 vocab: int) -> torch.Tensor:
    """Mean token cross-entropy in float32; logits may be vocab-padded
    (the padded entries masked with -1e9)."""
    return _token_xent(logits, labels, vocab).mean()


def _chunk_xent_sum(xc: torch.Tensor, embed_t: torch.Tensor,
                    lc: torch.Tensor, vocab: int) -> torch.Tensor:
    return _token_xent(xc.float() @ embed_t.float().T, lc, vocab).sum()


def chunked_softmax_xent(x: torch.Tensor, embed_t: torch.Tensor,
                         labels: torch.Tensor, vocab: int,
                         chunk: int = 512) -> torch.Tensor:
    """``softmax_xent`` of ``x @ embed_t.T`` without the full (B, S, V)
    logits: S // `chunk` sequence chunks in order, their float32 sums
    added from zero (the JAX ``lax.scan``'s order), each chunk's logits
    recomputed in the backward pass (``torch.utils.checkpoint``) rather
    than kept. x: (B, S, D) final hidden; embed_t: (V, D) output
    embedding. S must be a multiple of `chunk`, as the JAX reshape
    demands; any other S raises ``ValueError``."""
    from torch.utils.checkpoint import checkpoint

    B, S, D = x.shape
    if S % chunk:
        raise ValueError(f"chunked_softmax_xent: sequence length {S} is not "
                         f"a multiple of the loss chunk {chunk}")
    n = S // chunk
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n):
        sl = slice(i * chunk, (i + 1) * chunk)
        total = total + checkpoint(_chunk_xent_sum, x[:, sl], embed_t,
                                   labels[:, sl], vocab,
                                   use_reentrant=False)
    return total / (B * S)


def count_params(params) -> int:
    """Elements in every leaf of a nested (or flat) tree of tensors or
    arrays."""
    if isinstance(params, dict):
        return sum(count_params(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(count_params(v) for v in params)
    return math.prod(params.shape)
