"""Minimal module system: the part of the ``flax.linen`` API this package uses.

A ``Module`` subclass is a dataclass of hyper-parameters. Its variables live
outside it, in nested dicts ``{collection: {submodule name: ... {leaf}}}``
that ``init`` creates and ``apply`` reads. Surface: ``Module``, ``compact``,
``setup``, ``param``, ``variable``, ``is_initializing``, ``init``, ``apply``
(``method=``, ``mutable=``) and ``initializers``.

Submodules are named as ``flax.linen`` names them: an explicit ``name=``,
the attribute a ``setup`` assigns them to, or ``ClassName_N`` counted per
class within one call of a ``@compact`` method. Parameter initial values
use flax's RNG derivation (the root key folded with the SHA-1 of the scope
path and a per-scope counter), so ``init`` gives the same variable tree and
the same values as flax would, and checkpoints carry over either way.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import inspect
import threading
from collections.abc import Mapping
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp

initializers = jax.nn.initializers

_context = threading.local()


def _module_stack() -> list:
    if not hasattr(_context, "stack"):
        _context.stack = []
    return _context.stack


def compact(fn: Callable) -> Callable:
    """Mark a method that may create submodules and parameters inline."""
    fn.compact = True
    return fn


def _fold_in_static(rng, data: Tuple) -> jax.Array:
    """flax's fold of static path data into a key (flax core/scope.py)."""
    if not data:
        return rng
    m = hashlib.sha1()
    for x in data:
        if isinstance(x, str):
            m.update(x.encode("utf-8"))
        else:
            m.update(x.to_bytes((x.bit_length() + 7) // 8, byteorder="big"))
    hash_int = int.from_bytes(m.digest()[:4], byteorder="big")
    return jax.random.fold_in(rng, jnp.uint32(hash_int))


class _Root:
    """Variables, parameter key and mutability shared by one init/apply."""

    def __init__(self, variables, rng, mutable, initializing: bool):
        self.variables = variables
        self.rng = rng
        self.mutable = mutable          # True (every collection) or a frozenset
        self.initializing = initializing
        self.rng_counters = {}

    def is_mutable(self, col: str) -> bool:
        return self.mutable is True or col in self.mutable


@dataclasses.dataclass(frozen=True)
class _Scope:
    root: _Root
    path: Tuple[str, ...]

    def get(self, col: str, name: str):
        node = self.root.variables.get(col)
        for p in self.path:
            if not isinstance(node, Mapping):
                return None
            node = node.get(p)
        return node.get(name) if isinstance(node, Mapping) else None

    def put(self, col: str, name: str, value) -> None:
        if not self.root.is_mutable(col):
            raise ValueError(f"collection {col!r} is immutable at "
                             f"{'/'.join(self.path + (name,))}; pass "
                             f"mutable=[{col!r}] to apply")
        node = self.root.variables.setdefault(col, {})
        for p in self.path:
            node = node.setdefault(p, {})
        node[name] = value

    def make_rng(self) -> jax.Array:
        if self.root.rng is None:
            raise ValueError("init needs a PRNG key for 'params'")
        count = self.root.rng_counters.get(self.path, 0) + 1
        self.root.rng_counters[self.path] = count
        return _fold_in_static(self.root.rng, self.path + (count,))


class Variable:
    """Handle on one variable; ``.value`` reads and (if mutable) writes it."""

    def __init__(self, scope: _Scope, col: str, name: str):
        self._scope, self._col, self._name = scope, col, name

    @property
    def value(self):
        return self._scope.get(self._col, self._name)

    @value.setter
    def value(self, v):
        self._scope.put(self._col, self._name, v)


class _State:
    def __init__(self):
        self.scope: Optional[_Scope] = None
        self.setup_done = False
        self.in_setup = False
        self.in_compact = False
        self.autoname = {}


def _wrap_method(fn: Callable) -> Callable:
    is_compact = getattr(fn, "compact", False)
    is_setup = fn.__name__ == "setup"

    @functools.wraps(fn)
    def wrapped(self, *args, **kwargs):
        st = self._state
        if st.scope is None:  # unbound: a plain method
            return fn(self, *args, **kwargs)
        if not is_setup:
            self._try_setup()
        was_setup, was_compact = st.in_setup, st.in_compact
        st.in_setup = st.in_setup or is_setup
        st.in_compact = st.in_compact or is_compact
        stack = _module_stack()
        stack.append(self)
        try:
            return fn(self, *args, **kwargs)
        finally:
            stack.pop()
            st.in_setup, st.in_compact = was_setup, was_compact
            if (is_compact or is_setup) and not (was_setup or was_compact):
                st.autoname = {}

    return wrapped


@dataclasses.dataclass(eq=False)
class Module:
    """Base class: subclasses become dataclasses of their hyper-parameters."""
    name: Optional[str] = dataclasses.field(default=None, kw_only=True)

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        for attr, obj in list(vars(cls).items()):
            if inspect.isfunction(obj) and (attr == "__call__"
                                            or not attr.startswith("__")):
                setattr(cls, attr, _wrap_method(obj))
        dataclasses.dataclass(cls, unsafe_hash=True)

    def __post_init__(self):
        st = _State()
        object.__setattr__(self, "_state", st)
        stack = _module_stack()
        parent = stack[-1] if stack else None
        if parent is None:
            return
        pst = parent._state
        if pst.in_setup and self.name is None:
            return  # named by the attribute setup() assigns it to
        if not (pst.in_setup or pst.in_compact):
            raise TypeError(f"{type(self).__name__} must be created in setup() "
                            f"or a @compact method of {type(parent).__name__}")
        if self.name is None:
            prefix = type(self).__name__
            cursor = pst.autoname.get(prefix, 0)
            pst.autoname[prefix] = cursor + 1
            object.__setattr__(self, "name", f"{prefix}_{cursor}")
        st.scope = _Scope(pst.scope.root, pst.scope.path + (self.name,))

    def __setattr__(self, attr, value):
        st = self.__dict__.get("_state")
        if (st is not None and st.in_setup and isinstance(value, Module)
                and value._state.scope is None):
            object.__setattr__(value, "name", attr)
            value._state.scope = _Scope(st.scope.root, st.scope.path + (attr,))
        object.__setattr__(self, attr, value)

    def __getattr__(self, attr):
        # only reached when normal lookup fails: run a pending setup() first
        st = self.__dict__.get("_state")
        if st is not None and st.scope is not None and not st.setup_done:
            self._try_setup()
            return object.__getattribute__(self, attr)
        raise AttributeError(f"{type(self).__name__!r} has no attribute {attr!r}")

    def _try_setup(self):
        st = self._state
        if not st.setup_done:
            st.setup_done = True
            self.setup()

    def setup(self):
        """Override to define submodules and variables as attributes."""

    def _bound_scope(self) -> _Scope:
        scope = self._state.scope
        if scope is None:
            raise ValueError(f"{type(self).__name__} is not bound: call it "
                             "through init or apply")
        return scope

    # -- variables ---------------------------------------------------------
    def param(self, name: str, init_fn: Callable, *init_args):
        scope = self._bound_scope()
        value = scope.get("params", name)
        if value is None:
            if not scope.root.is_mutable("params"):
                raise ValueError(
                    f"no parameter {'/'.join(scope.path + (name,))!r}")
            value = init_fn(scope.make_rng(), *init_args)
            scope.put("params", name, value)
        return value

    def variable(self, col: str, name: str, init_fn: Callable, *init_args):
        scope = self._bound_scope()
        if scope.get(col, name) is None:
            scope.put(col, name, init_fn(*init_args))
        return Variable(scope, col, name)

    def is_initializing(self) -> bool:
        return self._bound_scope().root.initializing

    # -- entry points ------------------------------------------------------
    def _run(self, root: _Root, method, args, kwargs):
        stack = _module_stack()
        stack.append(None)  # the bound copy is a root, not a child
        try:
            bound = dataclasses.replace(self)
        finally:
            stack.pop()
        bound._state.scope = _Scope(root, ())
        if method is None:
            return bound(*args, **kwargs)
        if isinstance(method, str):
            return getattr(bound, method)(*args, **kwargs)
        return method(bound, *args, **kwargs)

    def init(self, rngs, *args, method=None, **kwargs) -> dict:
        """Create every variable the call touches; returns the variable tree."""
        rng = rngs["params"] if isinstance(rngs, Mapping) else rngs
        root = _Root({}, rng, True, True)
        self._run(root, method, args, kwargs)
        return root.variables

    def apply(self, variables: Mapping, *args, method=None, mutable=False,
              **kwargs):
        """Run ``method`` (default ``__call__``) on ``variables``.

        With ``mutable`` (a collection name or list of them) returns
        ``(output, {collection: updated tree})``.
        """
        if mutable is False:
            cols = frozenset()
        elif mutable is True:
            cols = True
        else:
            cols = frozenset([mutable] if isinstance(mutable, str) else mutable)
        copy = lambda t: ({k: copy(v) for k, v in t.items()}  # noqa: E731
                          if isinstance(t, Mapping) else t)
        tree = {col: (copy(t) if cols is True or col in cols else t)
                for col, t in variables.items()}
        root = _Root(tree, None, cols, False)
        out = self._run(root, method, args, kwargs)
        if mutable is False:
            return out
        return out, {col: t for col, t in root.variables.items()
                     if cols is True or col in cols}
