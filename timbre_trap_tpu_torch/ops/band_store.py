"""Level specs kept across weight updates: every conv's band operands in a
few buffers that stay put, refreshed from the weights by one gather.

Each entry of a conv's band weights (``ConvBlocks.band_weights``), of its
bias pattern, of its adjoint's band weights and of its dense blocks is one
weight or zero, in a pattern that the shapes alone fix. ``BandStore`` reads
that pattern once from specs built on position-valued parameters (the
value ``1 + i`` for element i of the parameters flattened in order, so a
block entry holds the position of the weight it copies, 0 where it holds
none) and keeps:

* the geometry: those specs' LevelSpecs and ConvBlocks themselves (taps,
  bands, margins and the K1 plans they cache), now backed by the store;
* static index tables on the weights' device, into the flattened
  parameters with a zero sentinel at the end: ``f`` = [every conv's band
  weights | every adjoint's band weights | every bias pattern], and ``D`` =
  each level's dense blocks and biases, conv after conv, the layout of the
  dW and dBias that K3 returns; and the tables of ``D``'s segment sum;
* the operand buffers, allocated once: ``f`` (float32), its bfloat16 copy
  and the TF32 planes of the forward band weights, the last two derived
  once a refresh when first asked for.

``refresh`` is one autograd Function over the parameters the convs read.
Forward: the parameters flattened, gathered into ``f`` in place and into
``D``, whose per-level pieces ``fused_level_train`` takes as each level's
gradient route. Backward: the levels' dense dW and dBias, summed by
autograd over each level's uses, go back to the parameters by a fixed-order
segment sum: per group of elements read equally often, one gather into a
(elements, reads) table and one sum along its rows; no atomic scatter.
"""

import math

import torch

from .packed_conv import tf32_round

__all__ = ["BandStore"]

# Regions of the operand buffers start at multiples of this many elements
# (256 bytes of float32): the kernels' TMA boxes read each from its base.
_ALIGN = 64


def _padded(n):
    return -(-n // _ALIGN) * _ALIGN


class BandStore:
    """The kept operands of the convs of ``specs`` (LevelSpecs built from
    position-valued parameters on the CPU, with or without adjoints).
    ``shapes`` are the shapes of the network's float32 parameters in the
    order the positions count them; the store's buffers and tables live on
    ``device``. Takes the specs over: their convs read the store from now
    on (see ``ConvBlocks``)."""

    def __init__(self, specs, shapes, device):
        self.specs = list(specs)
        self.device = torch.device(device)
        sizes = [math.prod(s) for s in shapes]
        convs = [cb for spec in self.specs for cb in spec.convs()]
        adjoints = [cb.adjoint for cb in convs if cb.adjoint is not None]
        n_all = sum(sizes)
        if n_all >= 2 ** 24:
            raise ValueError("float32 positions count at most 2**24 weights")

        # Positions -> the flat vector of the parameters the convs read,
        # with the zero sentinel after them.
        read = torch.zeros(n_all + 1, dtype=torch.bool)
        for cb in convs:
            read[cb.blocks.flatten().long()] = True
            read[cb.bias.long()] = True
        starts = [0]
        for n in sizes:
            starts.append(starts[-1] + n)
        self._leaf_ids = [i for i, n in enumerate(sizes)
                          if read[starts[i] + 1:starts[i] + 1 + n].any()]
        self._shapes = [tuple(shapes[i]) for i in self._leaf_ids]
        n_flat = sum(sizes[i] for i in self._leaf_ids)
        remap = torch.full((n_all + 1,), n_flat, dtype=torch.int64)
        off = 0
        for i in self._leaf_ids:
            remap[starts[i] + 1:starts[i + 1] + 1] = torch.arange(
                off, off + sizes[i])
            off += sizes[i]
        self._numels = [sizes[i] for i in self._leaf_ids]

        def index(positions):
            return remap[positions.flatten().long()]

        # f: band weights (forward convs first, then adjoints), biases.
        parts, n_f = [], 0

        def place(idx):
            nonlocal n_f
            start, pad = n_f, _padded(idx.numel()) - idx.numel()
            parts.append(idx)
            parts.append(torch.full((pad,), n_flat, dtype=torch.int64))
            n_f += idx.numel() + pad
            return start

        self._band = {}
        for cb in convs + adjoints:
            w = cb.band_weights()
            self._band[cb] = (place(index(w)), tuple(w.shape))
        self._n_fwd = self._band[adjoints[0]][0] if adjoints else n_f
        self._n_band = n_f
        self._bias = {cb: (place(index(cb.bias)), cb.bias.numel())
                      for cb in convs + adjoints}
        idx_f = torch.cat(parts)

        # D: each level's dense blocks and bias, conv after conv.
        d_parts, self._dense, self._level_sizes = [], {}, []
        for level, spec in enumerate(self.specs):
            offsets, n = {}, 0
            for cb in spec.convs():
                offsets[cb] = n
                self._dense[cb] = (level, n, tuple(cb.blocks.shape))
                d_parts += [index(cb.blocks), index(cb.bias)]
                n += cb.blocks.numel() + cb.bias.numel()
            spec.grad_offsets, spec.grad_size = offsets, n
            self._level_sizes.append(n)
        idx_d = torch.cat(d_parts)
        # The adjoints' dense blocks (for the plain twins), by one gather.
        self._adj_dense, a_parts, n_a = {}, [], 0
        for cb in adjoints:
            self._adj_dense[cb] = (n_a, tuple(cb.blocks.shape))
            a_parts.append(index(cb.blocks))
            n_a += cb.blocks.numel()
        idx_a = torch.cat(a_parts) if a_parts else torch.zeros(0)

        # D's segment sum: the D offsets of each flat element, in order.
        g = torch.nonzero(idx_d < n_flat).squeeze(1)
        elem = idx_d[g]
        order = torch.argsort(elem * idx_d.numel() + g)
        elem, g = elem[order], g[order]
        counts = torch.bincount(elem, minlength=n_flat)
        first = torch.cumsum(counts, 0) - counts
        groups, members = [], []
        for c in sorted(set(counts.tolist()) - {0}):
            ids = torch.nonzero(counts == c).squeeze(1)
            groups.append(g[first[ids][:, None] + torch.arange(c)])
            members.append(ids)
        n_read = sum(m.numel() for m in members)
        inv = torch.full((n_flat,), n_read, dtype=torch.int64)
        inv[torch.cat(members)] = torch.arange(n_read)

        # TF32 planes of the forward band weights, (n_w, n_dt, 2, 64, width)
        # a conv: plane 0 reads hi = f[i], plane 1 lo = f[n_fwd + i].
        p_parts, n_p, self._planes_at = [], 0, {}
        for cb in convs:
            start, shape = self._band[cb]
            n = math.prod(shape)
            base = torch.arange(start, start + n).view(
                shape[0] * shape[1], 1, shape[2] * shape[3])
            p_parts.append(torch.cat((base, base + self._n_fwd), 1).flatten())
            p_parts.append(torch.zeros(_padded(2 * n) - 2 * n,
                                       dtype=torch.int64))
            self._planes_at[cb] = (n_p, shape[:2] + (2,) + shape[2:])
            n_p += _padded(2 * n)

        dev = self.device
        self._idx_f = idx_f.to(torch.int32).to(dev)
        self._idx_d = idx_d.to(torch.int32).to(dev)
        self._idx_p = torch.cat(p_parts).to(torch.int32).to(dev)
        self._idx_a = idx_a.to(torch.int32).to(dev)
        self._groups = [t.to(dev) for t in groups]
        self._inv = inv.to(dev)
        self._zero = torch.zeros(1, dtype=torch.float32, device=dev)
        self.f = torch.empty(n_f, dtype=torch.float32, device=dev)
        self._b16 = self._planes = None
        self.gen, self._b16_gen, self._planes_gen = 0, -1, -1
        self._flat = self._levels = self._dense_key = None

        for cb in convs + adjoints:
            cb._blocks = cb._bias = None
            cb._store = self
        for spec in self.specs:
            spec.store = self

    # ------------------------------------------------------------------ #

    def refresh(self, params):
        """Write every conv's operands from ``params`` (the network's
        parameters in the order the positions counted them) and hand each
        level its gradient route (``LevelSpec.grad_route``)."""
        levels = _Refresh.apply(self, *[params[i] for i in self._leaf_ids])
        self._levels = levels
        for spec, route in zip(self.specs, levels):
            spec.grad_route = route

    def prepare(self, dtype):
        """Derive now the operands that K1 reads at ``dtype`` (bfloat16
        band weights, or float32's TF32 planes), else done on first use."""
        if dtype == torch.bfloat16:
            self._bf16()
        else:
            self._tf32()

    def _bf16(self):
        if self._b16_gen != self.gen:
            if self._b16 is None:
                self._b16 = torch.empty(self._n_band, dtype=torch.bfloat16,
                                        device=self.device)
            self._b16.copy_(self.f[:self._n_band])
            self._b16_gen = self.gen
        return self._b16

    def _tf32(self):
        if self._planes_gen != self.gen:
            if self._planes is None:
                self._planes = torch.empty(self._idx_p.numel(),
                                           dtype=torch.float32,
                                           device=self.device)
            w = self.f[:self._n_fwd]
            hi = tf32_round(w)
            torch.index_select(torch.cat((hi, w - hi)), 0, self._idx_p,
                               out=self._planes)
            self._planes_gen = self.gen
        return self._planes

    def band_operands(self, cb, dtype):
        """``cb.band_operands(dtype)``, bfloat16 or float32: views of the
        kept buffers, made once a conv and dtype."""
        key = ("band", dtype)
        if dtype == torch.bfloat16:
            buf = self._bf16()
        elif dtype == torch.float32:
            buf = self.f
        else:
            raise ValueError(f"the kept band operands are bfloat16 or "
                             f"float32, not {dtype}")
        hit = cb._cache.get(key)
        if hit is None:
            start, shape = self._band[cb]
            b, nb = self._bias[cb]
            hit = cb._cache[key] = (
                buf[start:start + math.prod(shape)].view(shape),
                self.f[b:b + nb])
        return hit

    def tf32_operands(self, cb):
        """``cb.band_tf32_operands()``: views of the kept TF32 planes."""
        self._tf32()
        hit = cb._cache.get(("tf32",))
        if hit is None:
            start, shape = self._planes_at[cb]
            b, nb = self._bias[cb]
            hit = cb._cache[("tf32",)] = (
                self._planes[start:start + math.prod(shape)].view(shape),
                self.f[b:b + nb])
        return hit

    def dense_views(self):
        """Point every conv's ``blocks`` and ``bias`` at the latest
        refresh: the forward convs' as views of its per-level outputs
        (differentiable when the refresh was and grad mode is on), the
        adjoints' from one gather of the flat weights."""
        key = (self.gen, torch.is_grad_enabled())
        if self._dense_key == key:
            return
        self._dense_key = key
        for cb, (level, off, shape) in self._dense.items():
            d = self._levels[level]
            n, nb = math.prod(shape), self._bias[cb][1]
            cb._blocks = d[off:off + n].view(shape)
            cb._bias = d[off + n:off + n + nb]
        adj = torch.index_select(self._flat, 0, self._idx_a)
        for cb, (off, shape) in self._adj_dense.items():
            b, nb = self._bias[cb]
            cb._blocks = adj[off:off + math.prod(shape)].view(shape)
            cb._bias = self.f[b:b + nb]

    def segment_sum(self, dense):
        """The parameters' gradients from the gradient of ``D`` (the
        levels' dense dW and dBias concatenated): each flat element's D
        entries summed in a fixed order."""
        sums = [dense[t].sum(1) for t in self._groups]
        flat = torch.cat(sums + [self._zero])[self._inv]
        return tuple(v.view(s) for v, s in
                     zip(flat.split(self._numels), self._shapes))


class _Refresh(torch.autograd.Function):
    """Forward: the parameters the convs read, flattened (with the zero
    sentinel), gathered into the store's ``f`` in place and into ``D``,
    returned split by level. Backward: ``BandStore.segment_sum``."""

    @staticmethod
    def forward(ctx, store, *leaves):
        flat = torch.cat([v.reshape(-1) for v in leaves] + [store._zero])
        torch.index_select(flat, 0, store._idx_f, out=store.f)
        dense = torch.index_select(flat, 0, store._idx_d)
        store._flat = flat
        store.gen += 1
        ctx.store = store
        return dense.split(store._level_sizes)

    @staticmethod
    def backward(ctx, *grads):
        return (None,) + ctx.store.segment_sum(torch.cat(grads))
