"""CTL (Color Transformation Language) scripts (counterpart of
``art_tpu/color/ctl.py``; the reference ART runs them through the ACES
CTL interpreter, clutstore.cc getCTLLut :876, get_CTL_params :686,
CTL_init_lut :1322, CTL_apply :1662, CTL_shaper_func :998).

The tokenizer, the recursive-descent parser, the ``@ART-param:`` /
``@ART-colorspace:`` / ``@ART-lut:`` / ``@ART-label:`` annotations and
the interpreter's statements are copies of the reference's. The
interpreter evaluates ``ART_main`` over varying r/g/b planes at once:
varying values are torch tensors, uniform ones Python floats, ints and
bools in float64 exactly where the reference keeps them so
(`_is_varying`, `_scalar_math`, `_binmath`). An ``if`` or ``return`` on
a varying condition runs both sides under a path mask and merges them
with ``where``. `bake_lut` evaluates the script on the lattice of the
PQ shaper's inverse, as CTL_init_lut does, on a device of the caller's
choice; `ctl_shaper` is the shaper the film simulation applies before
the baked table.
"""

from __future__ import annotations

import json
import math
import os
import re

import numpy as np
import torch

from art_tpu_torch.core.fmath import cbrt_xla, fdiv, fpow, fsqrt

# ---------------------------------------------------------------------------
# lexer

_TOKEN_RE = re.compile(r"""
    (?P<ws>\s+|//[^\n]*|/\*.*?\*/)
  | (?P<num>(?:\d+\.\d*|\.\d+|\d+)(?:[eE][+-]?\d+)?[fF]?)
  | (?P<id>[A-Za-z_][A-Za-z0-9_]*)
  | (?P<op><=|>=|==|!=|&&|\|\||[-+*/%!<>=(){}\[\],;?:.])
""", re.VERBOSE | re.DOTALL)

KEYWORDS = {"const", "float", "int", "bool", "void", "unsigned",
            "output", "input", "varying", "uniform", "if", "else", "for",
            "while", "return", "true", "false", "import", "namespace",
            "struct", "half"}


def _tokenize(src):
    out = []
    pos = 0
    n = len(src)
    while pos < n:
        m = _TOKEN_RE.match(src, pos)
        if not m:
            raise CTLError(f"bad character {src[pos]!r} at offset {pos}")
        pos = m.end()
        if m.lastgroup == "ws":
            continue
        if m.lastgroup == "num":
            t = m.group().rstrip("fF")
            v = float(t) if ("." in t or "e" in t or "E" in t) else int(t)
            out.append(("num", v))
        elif m.lastgroup == "id":
            out.append(("kw" if m.group() in KEYWORDS else "id", m.group()))
        else:
            out.append(("op", m.group()))
    out.append(("eof", ""))
    return out


class CTLError(Exception):
    pass


# ---------------------------------------------------------------------------
# parser (recursive descent -> tuple AST)

class _Parser:
    def __init__(self, tokens):
        self.toks = tokens
        self.i = 0

    def peek(self, k=0):
        return self.toks[min(self.i + k, len(self.toks) - 1)]

    def next(self):
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect(self, kind, value=None):
        t = self.next()
        if t[0] != kind or (value is not None and t[1] != value):
            raise CTLError(f"expected {value or kind}, got {t}")
        return t

    def accept(self, kind, value=None):
        t = self.peek()
        if t[0] == kind and (value is None or t[1] == value):
            self.i += 1
            return True
        return False

    # ---- top level ----
    def parse(self):
        consts = []
        funcs = {}
        while self.peek()[0] != "eof":
            if self.accept("kw", "import"):
                # import "name"; -- stdlib modules are builtin here
                while not self.accept("op", ";"):
                    self.next()
                continue
            is_const = self.accept("kw", "const")
            base = self.expect("kw")[1]  # float/int/bool/void
            ret_dims = self._dims()
            name = self.expect("id")[1]
            if self.peek() == ("op", "("):
                funcs[name] = self._function(base, ret_dims, name)
            else:
                decls = self._decl_tail(name)
                consts.extend(decls)
                _ = is_const
        return consts, funcs

    def _dims(self):
        dims = []
        while self.peek() == ("op", "["):
            self.next()
            t = self.next()
            dims.append(int(t[1]) if t[0] == "num" else None)
            self.expect("op", "]")
        return dims

    def _decl_tail(self, first_name):
        """after `type name`: [dims] [= init] {, name ...} ;"""
        decls = []
        name = first_name
        while True:
            dims = self._dims()
            init = None
            if self.accept("op", "="):
                init = self._init_expr()
            decls.append((name, dims, init))
            if self.accept("op", ";"):
                return decls
            self.expect("op", ",")
            name = self.expect("id")[1]

    def _init_expr(self):
        if self.peek() == ("op", "{"):
            self.next()
            elems = []
            while not self.accept("op", "}"):
                elems.append(self._init_expr())
                if self.peek() == ("op", ","):
                    self.next()
            return ("init_list", elems)
        return self._expr()

    def _function(self, ret_base, ret_dims, name):
        self.expect("op", "(")
        params = []
        while not self.accept("op", ")"):
            is_output = False
            while self.peek()[0] == "kw" and self.peek()[1] in (
                    "output", "input", "varying", "uniform", "const"):
                if self.peek()[1] == "output":
                    is_output = True
                self.next()
            self.expect("kw")  # base type
            pdims = self._dims()
            pname = self.expect("id")[1]
            pdims = pdims + self._dims()
            default = None
            if self.accept("op", "="):
                default = self._init_expr()
            params.append((pname, pdims, is_output, default))
            if self.peek() == ("op", ","):
                self.next()
        body = self._block()
        return ("func", name, params, body, ret_dims)

    # ---- statements ----
    def _block(self):
        self.expect("op", "{")
        stmts = []
        while not self.accept("op", "}"):
            stmts.append(self._stmt())
        return ("block", stmts)

    def _stmt(self):
        t = self.peek()
        if t == ("op", "{"):
            return self._block()
        if t == ("kw", "if"):
            self.next()
            self.expect("op", "(")
            cond = self._expr()
            self.expect("op", ")")
            then = self._stmt()
            els = None
            if self.accept("kw", "else"):
                els = self._stmt()
            return ("if", cond, then, els)
        if t == ("kw", "for"):
            self.next()
            self.expect("op", "(")
            init = self._simple_stmt()
            cond = self._expr()
            self.expect("op", ";")
            step = self._assign_or_expr()
            self.expect("op", ")")
            body = self._stmt()
            return ("for", init, cond, step, body)
        if t == ("kw", "while"):
            self.next()
            self.expect("op", "(")
            cond = self._expr()
            self.expect("op", ")")
            return ("while", cond, self._stmt())
        if t == ("kw", "return"):
            self.next()
            if self.accept("op", ";"):
                return ("return", None)
            e = self._expr()
            self.expect("op", ";")
            return ("return", e)
        st = self._simple_stmt()
        return st

    def _simple_stmt(self):
        """declaration or assignment/expr, consuming the trailing ;"""
        t = self.peek()
        if t[0] == "kw" and t[1] in ("const", "float", "int", "bool",
                                     "unsigned", "half"):
            while self.peek()[0] == "kw":
                self.next()
            name = self.expect("id")[1]
            decls = self._decl_tail(name)
            return ("decl", decls)
        st = self._assign_or_expr()
        self.expect("op", ";")
        return st

    def _assign_or_expr(self):
        e = self._expr()
        if self.peek() == ("op", "="):
            self.next()
            rhs = self._init_expr()
            return ("assign", e, rhs)
        return ("expr", e)

    # ---- expressions (C precedence) ----
    def _expr(self):
        return self._ternary()

    def _ternary(self):
        c = self._or()
        if self.accept("op", "?"):
            a = self._expr()
            self.expect("op", ":")
            b = self._expr()
            return ("ternary", c, a, b)
        return c

    def _binop(self, sub, ops):
        e = sub()
        while self.peek()[0] == "op" and self.peek()[1] in ops:
            op = self.next()[1]
            e = ("bin", op, e, sub())
        return e

    def _or(self):
        return self._binop(self._and, ("||",))

    def _and(self):
        return self._binop(self._eq, ("&&",))

    def _eq(self):
        return self._binop(self._rel, ("==", "!="))

    def _rel(self):
        return self._binop(self._add, ("<", ">", "<=", ">="))

    def _add(self):
        return self._binop(self._mul, ("+", "-"))

    def _mul(self):
        return self._binop(self._unary, ("*", "/", "%"))

    def _unary(self):
        t = self.peek()
        if t == ("op", "-"):
            self.next()
            return ("un", "-", self._unary())
        if t == ("op", "!"):
            self.next()
            return ("un", "!", self._unary())
        if t == ("op", "+"):
            self.next()
            return self._unary()
        return self._postfix()

    def _postfix(self):
        e = self._primary()
        while True:
            if self.peek() == ("op", "["):
                self.next()
                idx = self._expr()
                self.expect("op", "]")
                e = ("index", e, idx)
            else:
                return e

    def _primary(self):
        t = self.next()
        if t[0] == "num":
            return ("num", t[1])
        if t == ("kw", "true"):
            return ("num", True)
        if t == ("kw", "false"):
            return ("num", False)
        if t[0] == "kw" and t[1] in ("float", "int", "bool", "half"):
            # cast syntax: float(x)
            self.expect("op", "(")
            e = self._expr()
            self.expect("op", ")")
            return ("call", t[1], [e])
        if t[0] == "id":
            if self.peek() == ("op", "("):
                self.next()
                args = []
                while not self.accept("op", ")"):
                    args.append(self._expr())
                    if self.peek() == ("op", ","):
                        self.next()
                return ("call", t[1], args)
            return ("var", t[1])
        if t == ("op", "("):
            e = self._expr()
            self.expect("op", ")")
            return e
        raise CTLError(f"unexpected token {t}")


# ---------------------------------------------------------------------------
# evaluator

def _is_varying(v):
    return hasattr(v, "shape") and getattr(v, "ndim", 0) > 0


def _tensors(a, b):
    """Two operands as tensors on the varying one's device, a Python
    number typed as JAX types a weak scalar: a float beside an integer
    or bool tensor is float32, else the number takes the tensor's type;
    two numbers become float32, int32 or bool tensors on the CPU."""
    ref = a if torch.is_tensor(a) else b if torch.is_tensor(b) else None

    def conv(x):
        if torch.is_tensor(x):
            return x
        if ref is None:
            dt = (torch.bool if isinstance(x, bool) else torch.int32
                  if isinstance(x, int) else torch.float32)
            return torch.tensor(x, dtype=dt)
        dt = ref.dtype
        if isinstance(x, float) and not dt.is_floating_point:
            dt = torch.float32
        return torch.tensor(x, dtype=dt, device=ref.device)

    return conv(a), conv(b)


def _where(m, a, b):
    if isinstance(a, list):
        return [_where(m, x, y) for x, y in zip(a, b)]
    return torch.where(m, *_tensors(a, b))


def _mask_and(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return a & b


def _mask_not(a):
    if a is None:
        return None
    return ~a if _is_varying(a) else (not a)


def _zeros(dims):
    if not dims:
        return 0.0
    return [_zeros(dims[1:]) for _ in range(dims[0])]


def _scalar_math(fname, pyf, tf):
    def g(x):
        if isinstance(x, list):
            return [g(e) for e in x]
        if _is_varying(x):
            return tf(x)
        try:
            return pyf(float(x))
        except (ValueError, OverflowError):
            return float(tf(torch.tensor(float(x), dtype=torch.float32)))
    return g


def _binmath(pyf, tf):
    def g(a, b):
        if _is_varying(a) or _is_varying(b):
            return tf(*_tensors(a, b))
        return pyf(float(a), float(b))
    return g


def _div(a, b):
    """a / b as an IEEE division where either is a tensor (PyTorch's CUDA
    division by a Python number multiplies by its reciprocal)."""
    if torch.is_tensor(a) or torch.is_tensor(b):
        a, b = _tensors(a, b)
        if not (a.dtype.is_floating_point or b.dtype.is_floating_point):
            a = a.to(torch.float32)
        return torch.true_divide(a, b)
    return a / b


def _cbrt(x):
    return torch.sign(x) * cbrt_xla(torch.abs(x))


def _mat_invert33(m):
    a, b, c = m[0]
    d, e, f = m[1]
    g, h, i = m[2]
    det = a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)
    inv = [
        [(e * i - f * h), (c * h - b * i), (b * f - c * e)],
        [(f * g - d * i), (a * i - c * g), (c * d - a * f)],
        [(d * h - e * g), (b * g - a * h), (a * e - b * d)],
    ]
    return [[x / det for x in row] for row in inv]


def _builtins():
    B = {}
    for name, pyf, tf in [
        ("pow", math.pow, fpow), ("pow_F", math.pow, fpow),
        ("atan2", math.atan2, torch.atan2),
        ("fmod", math.fmod, torch.remainder),
        ("fmax", max, torch.maximum), ("fmin", min, torch.minimum),
        ("max", max, torch.maximum), ("min", min, torch.minimum),
        ("hypot", math.hypot, torch.hypot),
    ]:
        B[name] = _binmath(pyf, tf)
    for name, pyf, tf in [
        ("log", math.log, torch.log), ("log2", math.log2, torch.log2),
        ("log10", math.log10, torch.log10), ("exp", math.exp, torch.exp),
        ("exp2", lambda x: 2.0 ** x, torch.exp2),
        ("sqrt", math.sqrt, fsqrt),
        ("fabs", abs, torch.abs), ("abs", abs, torch.abs),
        ("floor", math.floor, torch.floor), ("ceil", math.ceil, torch.ceil),
        ("sin", math.sin, torch.sin), ("cos", math.cos, torch.cos),
        ("tan", math.tan, torch.tan), ("asin", math.asin, torch.asin),
        ("acos", math.acos, torch.acos), ("atan", math.atan, torch.atan),
        ("cbrt", lambda x: math.copysign(abs(x) ** (1 / 3), x), _cbrt),
        ("isnan_f", math.isnan, torch.isnan),
        ("isinf_f", math.isinf, torch.isinf),
        ("finite_f", math.isfinite, torch.isfinite),
        ("pow10", lambda x: 10.0 ** x, lambda x: fpow(10.0, x)),
    ]:
        B[name] = _scalar_math(name, pyf, tf)

    def clamp(x, lo, hi):
        if _is_varying(x) or _is_varying(lo) or _is_varying(hi):
            return torch.minimum(*_tensors(torch.maximum(*_tensors(x, lo)),
                                           hi))
        return min(max(x, lo), hi)

    B["clamp"] = clamp
    B["float"] = lambda x: x if _is_varying(x) else float(x)
    B["int"] = lambda x: x.to(torch.int32) if _is_varying(x) else int(x)
    B["bool"] = lambda x: x if _is_varying(x) else bool(x)
    B["half"] = B["float"]

    # ACES stdlib 3x3 / vec3 helpers
    B["invert_f33"] = _mat_invert33
    B["transpose_f33"] = lambda m: [[m[j][i] for j in range(3)]
                                    for i in range(3)]
    B["mult_f33_f33"] = lambda a, b: [
        [sum(a[i][k] * b[k][j] for k in range(3)) for j in range(3)]
        for i in range(3)]
    # row-vector times matrix (ctlsdk mult_f3_f33)
    B["mult_f3_f33"] = lambda v, m: [
        v[0] * m[0][j] + v[1] * m[1][j] + v[2] * m[2][j] for j in range(3)]
    B["mult_f_f3"] = lambda f, v: [f * x for x in v]
    B["mult_f_f33"] = lambda f, m: [[f * x for x in row] for row in m]
    B["add_f3_f3"] = lambda a, b: [x + y for x, y in zip(a, b)]
    B["sub_f3_f3"] = lambda a, b: [x - y for x, y in zip(a, b)]
    B["dot_f3_f3"] = lambda a, b: sum(x * y for x, y in zip(a, b))
    B["cross_f3_f3"] = lambda a, b: [
        a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0]]

    def length_f3(v):
        s = v[0] * v[0] + v[1] * v[1] + v[2] * v[2]
        return fsqrt(s) if _is_varying(s) else math.sqrt(s)

    B["length_f3"] = length_f3
    B["print_bool"] = B["print_int"] = B["print_float"] = lambda *a: 0.0
    B["assert"] = lambda *a: 0.0
    return B


_GLOBAL_CONSTS = {
    "M_PI": math.pi, "M_E": math.e, "FLT_MAX": 3.402823466e38,
    "FLT_MIN": 1.175494351e-38, "FLT_EPSILON": 1.19209290e-07,
    "HALF_MAX": 65504.0, "HALF_MIN": 6.10351562e-05, "M_LN2": math.log(2.0),
}


class _Return(Exception):
    def __init__(self, value):
        self.value = value


class _Env:
    def __init__(self, parent=None):
        self.vars = {}
        self.parent = parent

    def lookup(self, name):
        e = self
        while e is not None:
            if name in e.vars:
                return e
            e = e.parent
        return None

    def get(self, name):
        e = self.lookup(name)
        if e is None:
            raise CTLError(f"undefined variable {name}")
        return e.vars[name]

    def set(self, name, value, mask=None):
        e = self.lookup(name)
        if e is None:
            raise CTLError(f"assignment to undeclared {name}")
        if mask is None or mask is True:
            e.vars[name] = value
        elif mask is False:
            pass
        else:
            e.vars[name] = _where(mask, value, e.vars[name])

    def declare(self, name, value):
        self.vars[name] = value


class _Frame:
    """per-function-call return accumulator for masked returns."""

    def __init__(self):
        self.ret = None
        self.ret_mask = None  # None: not returned anywhere


class Interpreter:
    def __init__(self, consts, funcs):
        self.funcs = funcs
        self.builtins = _builtins()
        self.globals = _Env()
        for k, v in _GLOBAL_CONSTS.items():
            self.globals.declare(k, v)
        for name, dims, init in consts:
            v = self.eval(init, self.globals, None) if init is not None \
                else _zeros(dims)
            self.globals.declare(name, v)

    # ---- statement execution ----
    def exec_stmt(self, st, env, frame, mask):
        kind = st[0]
        live = _mask_and(mask, _mask_not(frame.ret_mask)) \
            if frame.ret_mask is not None else mask
        if live is False:
            return
        if kind == "block":
            block_env = _Env(env)
            for s in st[1]:
                self.exec_stmt(s, block_env, frame, mask)
            return
        if kind == "decl":
            for name, dims, init in st[1]:
                v = self.eval(init, env, live) if init is not None \
                    else _zeros(dims)
                env.declare(name, v)
            return
        if kind == "assign":
            val = self.eval(st[2], env, live)
            self._assign_lhs(st[1], val, env, live)
            return
        if kind == "expr":
            self.eval(st[1], env, live)
            return
        if kind == "if":
            cond = self.eval(st[1], env, live)
            if not _is_varying(cond):
                if cond:
                    self.exec_stmt(st[2], env, frame, mask)
                elif st[3] is not None:
                    self.exec_stmt(st[3], env, frame, mask)
                return
            self.exec_stmt(st[2], env, frame, _mask_and(live, cond))
            if st[3] is not None:
                self.exec_stmt(st[3], env, frame, _mask_and(live, ~cond))
            return
        if kind == "for":
            loop_env = _Env(env)
            self.exec_stmt(st[1], loop_env, frame, mask)
            guard = 0
            while True:
                cond = self.eval(st[2], loop_env, mask)
                if _is_varying(cond):
                    raise CTLError("varying loop condition not supported")
                if not cond:
                    return
                self.exec_stmt(st[4], loop_env, frame, mask)
                self.exec_stmt(st[3], loop_env, frame, mask)
                guard += 1
                if guard > 100000:
                    raise CTLError("loop bound exceeded")
            return
        if kind == "while":
            guard = 0
            while True:
                cond = self.eval(st[1], env, mask)
                if _is_varying(cond):
                    raise CTLError("varying loop condition not supported")
                if not cond:
                    return
                self.exec_stmt(st[2], env, frame, mask)
                guard += 1
                if guard > 100000:
                    raise CTLError("loop bound exceeded")
            return
        if kind == "return":
            val = self.eval(st[1], env, live) if st[1] is not None else None
            if live is None or live is True:
                frame.ret = val if frame.ret_mask is None \
                    else _where(frame.ret_mask, frame.ret, val)
                frame.ret_mask = True
                raise _Return(None)
            # partial (masked) return: accumulate
            if frame.ret is None:
                frame.ret = val
                frame.ret_mask = live
            else:
                frame.ret = _where(live, val, frame.ret)
                frame.ret_mask = _mask_and_or(frame.ret_mask, live)
            return
        raise CTLError(f"unknown statement {kind}")

    def _assign_lhs(self, lhs, val, env, mask):
        if lhs[0] == "var":
            env.set(lhs[1], val, mask)
            return
        if lhs[0] == "index":
            # resolve container chain
            idxs = []
            node = lhs
            while node[0] == "index":
                idxs.append(node[2])
                node = node[1]
            if node[0] != "var":
                raise CTLError("bad assignment target")
            container = env.get(node[1])
            idxs = [self.eval(i, env, mask) for i in reversed(idxs)]
            tgt = container
            for i in idxs[:-1]:
                tgt = tgt[int(i)]
            i = int(idxs[-1])
            if mask is None or mask is True:
                tgt[i] = val
            elif mask is not False:
                tgt[i] = _where(mask, val, tgt[i])
            return
        raise CTLError("bad assignment target")

    # ---- expressions ----
    def eval(self, e, env, mask):
        kind = e[0]
        if kind == "num":
            return e[1]
        if kind == "var":
            return env.get(e[1])
        if kind == "init_list":
            return [self.eval(x, env, mask) for x in e[1]]
        if kind == "un":
            v = self.eval(e[2], env, mask)
            if e[1] == "-":
                if isinstance(v, list):
                    return [-x for x in v]
                return -v
            if _is_varying(v):
                return ~v if v.dtype == torch.bool else (v == 0)
            return not v
        if kind == "bin":
            op = e[1]
            a = self.eval(e[2], env, mask)
            if op == "&&":
                if not _is_varying(a) and not a:
                    return False
                b = self.eval(e[3], env, mask)
                if _is_varying(a) or _is_varying(b):
                    return a & b
                return bool(a) and bool(b)
            if op == "||":
                if not _is_varying(a) and a:
                    return True
                b = self.eval(e[3], env, mask)
                if _is_varying(a) or _is_varying(b):
                    return a | b
                return bool(a) or bool(b)
            b = self.eval(e[3], env, mask)
            return _apply_binop(op, a, b)
        if kind == "ternary":
            c = self.eval(e[1], env, mask)
            if not _is_varying(c):
                return self.eval(e[2] if c else e[3], env, mask)
            return _where(c, self.eval(e[2], env, mask),
                          self.eval(e[3], env, mask))
        if kind == "index":
            base = self.eval(e[1], env, mask)
            idx = self.eval(e[2], env, mask)
            return base[int(idx)]
        if kind == "call":
            return self._call(e[1], e[2], env, mask)
        raise CTLError(f"unknown expression {kind}")

    def _call(self, name, arg_exprs, env, mask):
        if name in self.funcs:
            return self._call_user(self.funcs[name], arg_exprs, env, mask)
        if name in self.builtins:
            args = [self.eval(a, env, mask) for a in arg_exprs]
            return self.builtins[name](*args)
        raise CTLError(f"unknown function {name}")

    def _call_user(self, func, arg_exprs, env, mask):
        _, name, params, body, ret_dims = func
        call_env = _Env(self.globals)
        out_targets = []
        for k, (pname, pdims, is_output, default) in enumerate(params):
            if is_output:
                call_env.declare(pname, _zeros(pdims))
                if k < len(arg_exprs):
                    out_targets.append((pname, arg_exprs[k]))
            elif k < len(arg_exprs):
                v = self.eval(arg_exprs[k], env, mask)
                call_env.declare(pname, _copy_val(v))
            elif default is not None:
                call_env.declare(pname,
                                 self.eval(default, self.globals, None))
            else:
                call_env.declare(pname, _zeros(pdims))
        frame = _Frame()
        try:
            self.exec_stmt(body, call_env, frame, None)
        except _Return:
            pass
        # write back output params into the caller's lvalues
        for pname, target in out_targets:
            self._assign_lhs(target, call_env.get(pname), env, mask)
        return frame.ret


def _mask_and_or(a, b):
    """ret_mask union"""
    if a is None:
        return b
    if a is True or b is True:
        return True
    return a | b


def _copy_val(v):
    if isinstance(v, list):
        return [_copy_val(x) for x in v]
    return v


def _apply_binop(op, a, b):
    if op == "+":
        return a + b
    if op == "-":
        return a - b
    if op == "*":
        return a * b
    if op == "/":
        if isinstance(a, int) and isinstance(b, int):
            q = abs(a) // abs(b)
            return q if (a >= 0) == (b >= 0) else -q
        return _div(a, b)
    if op == "%":
        if isinstance(a, int) and isinstance(b, int):
            return math.fmod(a, b).__trunc__()
        return torch.remainder(*_tensors(a, b)) \
            if (_is_varying(a) or _is_varying(b)) else math.fmod(a, b)
    if op == "<":
        return a < b
    if op == ">":
        return a > b
    if op == "<=":
        return a <= b
    if op == ">=":
        return a >= b
    if op == "==":
        return a == b
    if op == "!=":
        return a != b
    raise CTLError(f"unknown operator {op}")


# ---------------------------------------------------------------------------
# @ART annotations (clutstore.cc get_CTL_params)

_COLORSPACES = {
    "aces2065-1": "ACESp0", "acescg": "ACESp1", "rec2020": "Rec2020",
    "prophoto": "ProPhoto", "rec709": "sRGB", "srgb": "sRGB",
    "adobergb": "Adobe RGB", "adobe": "Adobe RGB",
}


class CTLParam:
    def __init__(self, name, type_, label="", lo=0.0, hi=1.0,
                 default=0.0, step=0.0, choices=None, group=""):
        self.name = name
        self.type = type_  # float|int|bool|choice
        self.label = label
        self.lo = lo
        self.hi = hi
        self.default = default
        self.step = step
        self.choices = choices or []
        self.group = group


def _parse_art_param(arr):
    """clutparams.cc fill_from_json array forms."""
    if not isinstance(arr, list) or len(arr) < 2:
        return None
    name = arr[0]
    label = arr[1]
    rest = arr[2:]
    if len(rest) >= 1 and isinstance(rest[0], list):
        # choice: [name, label, [choices], default?, tooltip?]
        default = rest[1] if len(rest) > 1 and isinstance(
            rest[1], (int, float)) else 0
        return CTLParam(name, "choice", label, 0,
                        len(rest[0]) - 1, default, 1, rest[0])
    if len(rest) == 1 and isinstance(rest[0], bool):
        return CTLParam(name, "bool", label, 0, 1, bool(rest[0]))
    if len(rest) >= 2:
        lo, hi = float(rest[0]), float(rest[1])
        default = float(rest[2]) if len(rest) > 2 \
            and isinstance(rest[2], (int, float)) else lo
        step = float(rest[3]) if len(rest) > 3 \
            and isinstance(rest[3], (int, float)) else 0.0
        group = rest[4] if len(rest) > 4 and isinstance(rest[4], str) else ""
        is_int = all(float(x) == int(x)
                     for x in (rest[0], rest[1])) and len(rest) <= 4 \
            and step in (0.0, 1.0)
        t = "int" if (is_int and isinstance(rest[0], int)
                      and isinstance(rest[1], int) and step == 0.0) \
            else "float"
        return CTLParam(name, t, label, lo, hi, default, step, None, group)
    return None


class CTLScript:
    """A loaded CTL script with its ART annotations."""

    def __init__(self, path, text):
        self.path = path
        self.label = os.path.basename(path)
        self.colorspace = None
        self.lut_dim = 0
        self.params = []
        self._parse_annotations(text)
        consts, funcs = _Parser(_tokenize(text)).parse()
        if "ART_main" not in funcs:
            raise CTLError("no ART_main function")
        self.interp = Interpreter(consts, funcs)
        self.main = funcs["ART_main"]
        # defaults for params not annotated: from ART_main defaults
        declared = {p.name for p in self.params}
        for pname, pdims, is_output, default in self.main[2][6:]:
            if pname not in declared:
                d = 0.0
                if default is not None:
                    d = self.interp.eval(default, self.interp.globals, None)
                self.params.append(CTLParam(pname, "float", pname,
                                            0.0, 1.0, d))

    def _parse_annotations(self, text):
        for line in text.splitlines():
            s = line.strip()
            if s.startswith("//"):
                s = s[2:].strip()
            if s.startswith("@ART-param:"):
                try:
                    p = _parse_art_param(json.loads(s[len("@ART-param:"):]))
                    if p is not None:
                        self.params.append(p)
                except json.JSONDecodeError:
                    pass
            elif s.startswith("@ART-colorspace:"):
                try:
                    name = json.loads(s[len("@ART-colorspace:"):])
                    self.colorspace = _COLORSPACES.get(str(name).lower())
                except json.JSONDecodeError:
                    pass
            elif s.startswith("@ART-lut:"):
                try:
                    self.lut_dim = int(json.loads(s[len("@ART-lut:"):]))
                except (json.JSONDecodeError, ValueError):
                    pass
            elif s.startswith("@ART-label:"):
                try:
                    self.label = str(json.loads(s[len("@ART-label:"):]))
                except json.JSONDecodeError:
                    self.label = s[len("@ART-label:"):].strip()

    def default_values(self):
        return {p.name: float(p.default) for p in self.params}

    def __call__(self, r, g, b, values=None):
        """Run ART_main over varying planes (tensors of any one shape)."""
        vals = self.default_values()
        if values:
            for k, v in values.items():
                if k in vals:
                    vals[k] = float(v[0] if isinstance(v, (list, tuple))
                                    else v)
        params = self.main[2]
        env = _Env(self.interp.globals)
        call_env = _Env(self.interp.globals)
        outs = []
        for k, (pname, pdims, is_output, default) in enumerate(params):
            if k == 0:
                call_env.declare(pname, r)
            elif k == 1:
                call_env.declare(pname, g)
            elif k == 2:
                call_env.declare(pname, b)
            elif is_output:
                call_env.declare(pname, _zeros(pdims))
                outs.append(pname)
            else:
                v = vals.get(pname)
                if v is None:
                    v = self.interp.eval(default, self.interp.globals,
                                         None) if default is not None \
                        else 0.0
                call_env.declare(pname, v)
        frame = _Frame()
        try:
            self.interp.exec_stmt(self.main[3], call_env, frame, None)
        except _Return:
            pass
        del env
        if len(outs) >= 3:
            return tuple(call_env.get(n) for n in outs[:3])
        raise CTLError("ART_main lacks 3 output parameters")


_CACHE = {}


def load_ctl(path):
    """Parse + cache a CTL script (keyed by path + mtime)."""
    key = (path, os.path.getmtime(path))
    if key not in _CACHE:
        _CACHE.clear()
        with open(path) as f:
            _CACHE[key] = CTLScript(path, f.read())
    return _CACHE[key]


# ---------------------------------------------------------------------------
# shaper + LUT bake (CTL_shaper_func clutstore.cc:998, CTL_init_lut :1322)

_M1 = 2610.0 / 16384.0
_M2 = 2523.0 / 32.0
_C1 = 107.0 / 128.0
_C2 = 2413.0 / 128.0
_C3 = 2392.0 / 128.0
_SCALE = 100.0


def ctl_shaper(a, inv=False):
    """The PQ-style shaper, scene-linear [0, 100] <-> [0, 1], of a
    tensor."""
    a = torch.clamp(a, min=0.0)
    if not inv:
        aa = fpow(fdiv(a, _SCALE), _M1)
        return fpow((_C1 + _C2 * aa) / (1.0 + _C3 * aa), _M2)
    p = fpow(a, 1.0 / _M2)
    aa = torch.clamp(p - _C1, min=0.0) / (_C2 - _C3 * p)
    return fpow(aa, 1.0 / _M1) * _SCALE


def bake_lut(script, values=None, dim=None, device="cpu"):
    """(dim, dim, dim, 3) float32 numpy LUT over the shaper domain, as
    CTL_init_lut evaluates it (the input lattice is the shaper's inverse
    of [0, 1]^3), with the script run on `device`; dim defaults to the
    script's ``@ART-lut`` size, else 48."""
    d = dim or (script.lut_dim if script.lut_dim and script.lut_dim > 0
                else 48)
    grid = np.linspace(0.0, 1.0, d, dtype=np.float32)
    lattice = np.meshgrid(grid, grid, grid, indexing="ij")
    r, g, b = (ctl_shaper(torch.from_numpy(c.ravel()).to(device), inv=True)
               for c in lattice)
    outs = script(r, g, b, values)
    out = torch.stack([torch.as_tensor(o).to(torch.float32).reshape(d, d, d)
                       for o in outs], dim=-1)
    return out.cpu().numpy()
