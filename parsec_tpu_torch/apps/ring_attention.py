"""Ring attention: the long-context flagship over the ring pipeline.

The reference has no attention dimension (SURVEY §5.7 — its dataflow
rings are the PRIMITIVE); this app is the accelerator instantiation the
survey prescribes: sequence parallelism where each of P parties holds
one query block resident and the K/V blocks circulate the ring, with a
numerically-stable ONLINE-SOFTMAX accumulator (the flash-attention
recurrence) as the per-visit combine.  After P rounds every query block
has attended over the FULL sequence while only (2·Tkv·d)-sized KV
payloads ever moved — the classic ring-attention data movement, here as
a plain PTG over the runtime's neighbor-exchange schedule
(apps/ring.py), so it runs on one card or across ranks on the comm
engine unchanged.

Packing (everything rides two TiledMatrix collections):
- circulating block ``V(q)``: ``[K_q ; V_q]`` stacked — (2·Tkv, d)
- resident accumulator ``A(q)``: ``[Q_q | O | m | l]`` — (Tq, 2d+2)
  with the running output O, row-max m, and row-denominator l of the
  online softmax.  ``unpack_output`` unpacks O/l into the attention
  output.

The port's copy of the JAX package's apps/ring_attention.py.  Its
deliberate differences: the combines are torch ops on the tile's device
(``_combine_torch``/``_combine_torch_causal``, the ``jnp`` bodies there),
and serve as the CPU bodies too; a causal pool builds its diagonal mask
once per device; ``device`` defaults to ``"cuda"``, where the two
products are f32 ``torch.matmul`` with TF32 refused; ``pack_*``,
``unpack_output`` and ``dense_reference`` take numpy or tensors and give
tensors.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from parsec_tpu_torch.apps.cuda_kernels import check_f32_matmul
from parsec_tpu_torch.apps.ring import ring_pipeline_taskpool
from parsec_tpu_torch.core.taskpool import ParameterizedTaskpool
from parsec_tpu_torch.data.matrix import TiledMatrix


#: finite "minus infinity" for the running row-max: a literal -inf
#: would make the fully-masked causal case produce exp(-inf - -inf)
#: = exp(nan); masked probabilities are zeroed explicitly instead
_NEG = -1e30


def _tensor(x: Any) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x)


def pack_query(Q: Any) -> torch.Tensor:
    """Initial accumulator [Q | O=0 | m=-NEG | l=0] for one query block."""
    Q = _tensor(Q)
    Tq, d = Q.shape
    acc = torch.zeros((Tq, 2 * d + 2), dtype=torch.float32, device=Q.device)
    acc[:, :d] = Q
    acc[:, 2 * d] = _NEG
    return acc


def pack_kv(K: Any, V: Any) -> torch.Tensor:
    return torch.cat([_tensor(K), _tensor(V)], dim=0).to(torch.float32)


def unpack_output(acc: Any, d: int) -> torch.Tensor:
    """O / l — the softmax-normalized attention output."""
    acc = _tensor(acc)
    o = acc[:, d:2 * d]
    l = acc[:, 2 * d + 1:2 * d + 2]
    return o / torch.clamp(l, min=1e-30)


def _combine(acc: torch.Tensor, blk: torch.Tensor,
             mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One online-softmax visit: fold KV block ``blk`` into ``acc``
    (the flash-attention m/l/O recurrence).  ``mask`` (Tq, Tkv) of 0/1
    zeroes disallowed probabilities — scores are shifted to _NEG AND p
    is multiplied by the mask, so a fully masked block is an exact
    no-op (l and O unchanged)."""
    d = (acc.shape[1] - 2) // 2
    Tkv = blk.shape[0] // 2
    q = acc[:, :d]
    o = acc[:, d:2 * d]
    m = acc[:, 2 * d]
    l = acc[:, 2 * d + 1]
    k = blk[:Tkv]
    v = blk[Tkv:]
    s = (q @ k.T) * (1.0 / math.sqrt(d))
    if mask is not None:
        s = s * mask + _NEG * (1.0 - mask)
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[:, None])
    if mask is not None:
        p = p * mask
    alpha = torch.exp(m - m_new)
    l_new = alpha * l + p.sum(dim=-1)
    o_new = alpha[:, None] * o + p @ v
    return torch.cat([q, o_new, m_new[:, None], l_new[:, None]], dim=1)


def _combine_torch(acc, blk):
    return _combine(acc.to(torch.float32), blk.to(torch.float32))


# Causal masking rides the ring's VISIT CLASS (0 = block fully in the
# future: exact no-op; 1 = the diagonal block: lower triangle; 2 =
# fully in the past: unmasked).  With equal query/KV block lengths the
# diagonal mask is position-independent, so one mask serves every
# diagonal visit, and wavefront launch fusion still groups same-class
# visits.


def _causal_visit_class(P):
    def vc(q, t):
        kv = (q - t) % P
        return 2 if kv < q else (1 if kv == q else 0)
    return vc


def _combine_torch_causal(Tq, Tkv):
    #: the diagonal block's 0/1 lower-triangle mask, built once per
    #: device for this pool's (Tq, Tkv)
    masks: Dict[torch.device, torch.Tensor] = {}

    def fn(acc, blk, vc):
        a = acc.to(torch.float32)
        if int(vc) == 0:
            return a
        mask = None
        if int(vc) == 1:
            mask = masks.get(a.device)
            if mask is None:
                mask = masks.setdefault(a.device, torch.tril(torch.ones(
                    (Tq, Tkv), dtype=torch.float32, device=a.device)))
        return _combine(a, blk.to(torch.float32), mask)
    fn.masks = masks
    return fn


def ring_attention_taskpool(KV: TiledMatrix, ACC: TiledMatrix,
                            device: str = "cuda",
                            causal: bool = False) -> ParameterizedTaskpool:
    """P-party ring attention: ``KV(q)`` are the circulating packed
    [K;V] blocks, ``ACC(q)`` the resident packed [Q|O|m|l] accumulators
    (fill with pack_query/pack_kv; read back with unpack_output).
    ``causal=True`` applies the global-position causal mask per visit
    (block skips and the diagonal triangle fall out of one arithmetic
    mask, so the ring schedule is unchanged)."""
    if device in ("cuda", "gpu"):
        check_f32_matmul("ring attention")
    if causal:
        P = KV.mt
        Tkv = KV.mb // 2
        Tq = ACC.mb
        if Tq != Tkv:
            raise ValueError(
                "causal ring attention needs equal query/KV block "
                "lengths (the diagonal mask is then class-invariant)")
        return ring_pipeline_taskpool(
            KV, ACC, combine=_combine_torch_causal(Tq, Tkv), device=device,
            visit_class=_causal_visit_class(P))
    return ring_pipeline_taskpool(KV, ACC, combine=_combine_torch,
                                  device=device)


def dense_reference(Q: Any, K: Any, V: Any, causal: bool = False,
                    rows: Optional[int] = None) -> torch.Tensor:
    """Materialized-softmax attention over the full sequence, in the
    inputs' dtype on their device; ``rows`` query rows at a time (all at
    once by default) bound the score block's memory."""
    Q, K, V = _tensor(Q), _tensor(K), _tensor(V)
    n, d = Q.shape
    rows = rows or n
    out = torch.empty((n, V.shape[1]), dtype=V.dtype, device=V.device)
    cols = torch.arange(K.shape[0], device=Q.device)
    for r0 in range(0, n, rows):
        r1 = min(n, r0 + rows)
        s = (Q[r0:r1] @ K.T) / math.sqrt(d)
        if causal:
            here = torch.arange(r0, r1, device=Q.device)
            s = s.masked_fill(cols[None, :] > here[:, None], -math.inf)
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
        out[r0:r1] = (p / p.sum(dim=-1, keepdim=True)) @ V
    return out
