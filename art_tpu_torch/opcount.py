"""Operation count of a plain PyTorch function on the data of one run:
the element operations its result needs.

`needed_ops(fn)` runs fn once under a dispatch mode that records its aten
ops, then walks the record backwards from fn's result and marks, for each
tensor, the elements that reach the result. A select passes its mask on
(`torch.where` needs its first arm only where the condition holds and its
second only where it does not), and an element no result reads is not
counted, so a function that evaluates both arms of a select over a whole
plane is charged for the arm each element takes.

An op costs one operation per needed element of its result, a reduction
one per needed element of its input. Repeats are counted once: an op on the same inputs, or on inputs
all rolled by the same shift (`torch.roll` is periodic, so
op(roll(a, s), roll(b, s)) = roll(op(a, b), s)). Data movement (rolls,
views, slices, pads, gathers, stacks, copies) and ops on integer or
boolean tensors alone cost nothing.

Used for the operation half of a kernel's bound in ``chip_smoke.py``; an op
without a rule here raises rather than being guessed at.
"""

from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_unflatten
from torch.utils.weak import WeakIdKeyDictionary

# ops whose result is their input: same shape, same elements
IDENTITY = {"clone", "contiguous", "detach", "alias", "lift_fresh",
            "_to_copy", "lift_fresh_copy"}
# fresh values that take only a shape (and dtype, device) from a tensor
LIKE = {"full_like", "zeros_like", "ones_like", "empty_like", "new_full",
        "new_zeros", "new_ones", "new_empty", "empty_strided"}
# data movement: each result element is one input element (or a constant)
MOVES = {"select", "slice", "view", "_unsafe_view", "reshape", "expand",
         "permute", "transpose", "t", "unsqueeze", "squeeze", "flip",
         "stack", "cat", "constant_pad_nd", "reflection_pad1d",
         "reflection_pad2d", "replication_pad2d", "index_select", "index",
         "gather", "split", "split_with_sizes", "unbind", "narrow",
         "repeat", "_reshape_alias"}
# where a move's input tensors are indices, not data
_DATA = object()  # a move's data input, in its argument template
INDEX_ARGS = {"index_select": 2, "gather": 2}
REDUCTIONS = {"sum", "mean", "amax", "amin", "max", "min", "prod", "any",
              "all", "argmax", "argmin", "count_nonzero"}


def _leaf_key(leaf):
    """A non-tensor argument as part of a merge key."""
    if isinstance(leaf, (torch.dtype, torch.device, torch.layout,
                         torch.memory_format)):
        return str(leaf)
    return leaf


def _align(shift, shape, out_ndim):
    """shift (over an output of out_ndim dims) restricted to the dims of
    an input of `shape`, aligned right as in broadcasting."""
    return shift[out_ndim - len(shape):]


def _roll(t, shift):
    dims = [d for d, s in enumerate(shift) if s % t.shape[d]]
    if not dims:
        return t
    return torch.roll(t, [shift[d] for d in dims], dims)


def _reduce_to(mask, shape):
    """A needed-mask of a broadcast result, folded to an input's shape."""
    lead = mask.dim() - len(shape)
    if lead:
        mask = mask.any(dim=tuple(range(lead)))
    dims = tuple(d for d, n in enumerate(shape)
                 if n == 1 and mask.shape[d] != 1)
    if dims:
        mask = mask.any(dim=dims, keepdim=True)
    return mask


class _Entry:
    __slots__ = ("kind", "func", "outs", "ins", "floats", "extra")

    def __init__(self, kind, func, outs, ins, floats, extra=None):
        self.kind, self.func, self.outs = kind, func, outs
        self.ins, self.floats, self.extra = ins, floats, extra


class _Recorder(TorchDispatchMode):
    """Records ops as entries over tokens: a tensor is (token, shift), the
    token's plane rolled by `shift` (zero unless it came from rolls)."""

    def __init__(self):
        super().__init__()
        self.refs = WeakIdKeyDictionary()
        self.shapes = []  # token -> shape
        self.devices = []
        self.entries = []
        self.seen = {}  # merge key -> canonical output token
        self.naive = 0  # every float element-op, both arms, repeats

    def token(self, t):
        self.shapes.append(tuple(t.shape))
        self.devices.append(t.device)
        return len(self.shapes) - 1

    def ref(self, t):
        r = self.refs.get(t)
        if r is None:
            r = self.refs[t] = (self.token(t), (0,) * t.dim())
        return r

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.record(func, args, kwargs, out)
        return out

    def record(self, func, args, kwargs, out):
        name = func.overloadpacket.__name__.rstrip("_") \
            if func._schema.is_mutable else func.overloadpacket.__name__
        leaves, spec = tree_flatten((args, kwargs))
        tins = [a for a in leaves if isinstance(a, torch.Tensor)]
        touts = [o for o in tree_flatten(out)[0]
                 if isinstance(o, torch.Tensor)]
        if not touts:  # a value read to the host (.item(), .tolist())
            self.entries.append(_Entry("sink", func, [],
                                       [self.ref(t) for t in tins], False))
            return
        if func._schema.is_mutable:
            if touts[0]._base is not None:
                raise NotImplementedError(
                    f"needed_ops: in-place {func} on a view")
        if not tins or name in LIKE:  # a constant or a fresh buffer
            for o in touts:
                self.refs[o] = (self.token(o), (0,) * o.dim())
            return
        floats = any(t.is_floating_point() for t in (*tins, *touts))
        if floats and name not in IDENTITY and name not in MOVES \
                and name != "roll":
            self.naive += max(t.numel() for t in (*tins, *touts)
                              if t.is_floating_point())
        if name in IDENTITY:
            self.refs[touts[0]] = self.ref(tins[0])
            return
        if name == "roll":
            tok, sh = self.ref(args[0])
            shifts, dims = list(args[1]), list(args[2]) if len(args) > 2 \
                else list(kwargs.get("dims", []))
            if len(dims) != len(shifts):
                raise NotImplementedError("needed_ops: roll without dims")
            sh = list(sh)
            for s, d in zip(shifts, dims):
                d %= args[0].dim()
                sh[d] = (sh[d] + s) % args[0].shape[d]
            self.refs[touts[0]] = (tok, tuple(sh))
            return
        if name in MOVES:
            self.record_move(func, name, leaves, spec, touts)
        elif name in REDUCTIONS:
            self.record_reduce(func, args, kwargs, touts, floats)
        elif torch.Tag.pointwise in func.tags:
            self.record_elementwise(func, name, leaves, touts, floats)
        else:
            raise NotImplementedError(f"needed_ops: no rule for {func}")

    def record_elementwise(self, func, name, leaves, touts, floats):
        if len(touts) != 1:
            raise NotImplementedError(f"needed_ops: no rule for {func}")
        out = touts[0]
        shape = tuple(out.shape)
        tensors = [a for a in leaves if isinstance(a, torch.Tensor)]
        try:
            bshape = torch.broadcast_shapes(*(t.shape for t in tensors))
        except RuntimeError:
            bshape = None
        if bshape != shape:
            raise NotImplementedError(f"needed_ops: no rule for {func}")
        n = len(shape)
        refs = [self.ref(t) for t in tensors]
        s0 = next((sh for t, (_, sh) in zip(tensors, refs)
                   if tuple(t.shape) == shape), (0,) * n)
        rel = []
        for t, (tok, sh) in zip(tensors, refs):
            a = _align(s0, t.shape, n)
            rel.append((tok, tuple((s - z) % max(m, 1) for s, z, m
                                   in zip(sh, a, t.shape))))
        it = iter(rel)
        key = (func, tuple(next(it) if isinstance(a, torch.Tensor)
                           else _leaf_key(a) for a in leaves))
        if func._schema.is_mutable:
            key = None  # never merged
        tok = self.seen.get(key) if key is not None else None
        if tok is None:
            tok = self.token(out)
            extra = None
            if name == "where":
                # the condition in the canonical frame, and which inputs
                # are its arms
                cond = tensors[0]
                extra = (_roll(cond, [-s for s in _align(s0, cond.shape, n)]),
                         [i for i, a in enumerate(leaves[:3])
                          if isinstance(a, torch.Tensor)])
            self.entries.append(_Entry(
                "where" if name == "where" else "elem", func, [tok],
                [(r[0], r[1], tuple(t.shape)) for r, t in zip(rel, tensors)],
                floats, extra))
            if key is not None:
                self.seen[key] = tok
        self.refs[out] = (tok, tuple(s0))

    def record_move(self, func, name, leaves, spec, touts):
        idx_pos = INDEX_ARGS.get(name)
        data, template = [], []
        for i, a in enumerate(leaves):
            is_data = isinstance(a, torch.Tensor) and (
                (idx_pos is None and not (name == "index" and i > 0))
                or (idx_pos is not None and i == 0))
            if is_data:
                tok, sh = self.ref(a)
                data.append((tok, sh, tuple(a.shape)))
                template.append(_DATA)
            else:
                template.append(a)
        outs = [self.token(o) for o in touts]
        for o, tok in zip(touts, outs):
            self.refs[o] = (tok, (0,) * o.dim())
        self.entries.append(_Entry("move", func, outs, data, False,
                                   (name, template, spec)))

    def record_reduce(self, func, args, kwargs, touts, floats):
        bound = dict(zip((a.name for a in func._schema.arguments), args))
        bound.update(kwargs)
        src = args[0]
        dims = bound.get("dim")
        if dims is None or dims == []:
            dims = list(range(src.dim()))
        elif isinstance(dims, int):
            dims = [dims]
        dims = sorted(d % src.dim() for d in dims)
        keep = bool(bound.get("keepdim", False))
        outs = [self.token(o) for o in touts]
        for o, tok in zip(touts, outs):
            self.refs[o] = (tok, (0,) * o.dim())
        self.entries.append(_Entry("reduce", func, outs, [self.ref(src)],
                                   floats, (dims, keep, tuple(src.shape))))


def needed_ops(fn):
    """Run fn() once; return (its result, the operations its result
    needs, the naive count: every float element-op of every call, both
    arms of each select)."""
    rec = _Recorder()
    with rec:
        result = fn()
    roots = [t for t in tree_flatten(result)[0] if isinstance(t, torch.Tensor)]
    needed = {}

    def mark(tok, sh, mask):
        if any(sh):
            mask = _roll(mask, [-s for s in sh])
        cur = needed.get(tok)
        needed[tok] = mask if cur is None else cur | mask

    for t in roots:
        tok, sh = rec.ref(t)
        mark(tok, sh, torch.ones(t.shape, dtype=torch.bool, device=t.device))

    ops = 0
    for e in reversed(rec.entries):
        if e.kind == "sink":  # the host may read all of it
            for tok, sh in e.ins:
                mark(tok, sh, torch.ones(rec.shapes[tok], dtype=torch.bool,
                                         device=rec.devices[tok]))
            continue
        masks = [needed.pop(t, None) for t in e.outs]
        if all(m is None for m in masks):
            continue
        masks = [torch.zeros(rec.shapes[t], dtype=torch.bool,
                             device=rec.devices[t]) if m is None else m
                 for t, m in zip(e.outs, masks)]
        if e.kind in ("elem", "where"):
            m = masks[0]
            if e.floats:
                ops += int(m.sum())
            arms = {}
            if e.kind == "where":
                cond, pos = e.extra
                if len(pos) > 1 and pos[1] == 1:
                    arms[1] = m & cond
                if pos and pos[-1] == 2:
                    arms[len(pos) - 1] = m & ~cond
            for i, (tok, rel, shape) in enumerate(e.ins):
                mark(tok, rel, _reduce_to(arms.get(i, m), shape))
        elif e.kind == "reduce":
            dims, keep, shape = e.extra
            m = masks[0]
            for o in masks[1:]:
                m = m | o
            if not keep:
                for d in dims:
                    m = m.unsqueeze(d)
            m = m.expand(shape)
            if e.floats:
                ops += int(m.sum())
            tok, sh = e.ins[0]
            mark(tok, sh, m.contiguous())
        else:
            _propagate_move(e, masks, mark)
    return result, ops, rec.naive


def _propagate_move(e, masks, mark):
    """Run the move on element indices in place of its data: each needed
    result element names the input element it came from."""
    name, template, spec = e.extra
    leaves, off, offs = list(template), 0, []
    it = iter(e.ins)
    for i, a in enumerate(leaves):
        if a is _DATA:
            _, _, shape = next(it)
            n = 1
            for s in shape:
                n *= s
            dev = masks[0].device
            leaves[i] = torch.arange(off, off + n, dtype=torch.float64,
                                     device=dev).reshape(shape)
            offs.append(off)
            off += n
    args, kwargs = tree_unflatten(leaves, spec)
    if name == "constant_pad_nd":
        args = (args[0], args[1], -1.0)  # padding names no input element
    res = e.func(*args, **kwargs)
    res = [r for r in tree_flatten(res)[0] if isinstance(r, torch.Tensor)]
    sel = torch.cat([r[m].flatten() for r, m in zip(res, masks)])
    sel = sel[sel >= 0].long()
    for (tok, sh, shape), start in zip(e.ins, offs):
        n = 1
        for s in shape:
            n *= s
        part = sel[(sel >= start) & (sel < start + n)] - start
        view = torch.zeros(n, dtype=torch.bool, device=sel.device)
        view[part] = True
        mark(tok, sh, view.reshape(shape))
