"""Attribute-path configuration tree (the JAX package's ``config``).

An auto-vivifying attribute tree (``root.tinylm.n_blocks = 2``),
``update()`` from nested dicts and :func:`get`, which reads a leaf or a
default without vivifying it.  The port reads the engine knobs of the
training tick from it — ``remat``, ``attention_kernel``,
``attention_dtype``, ``fused_qkv``, ``precision_level`` and
``optimizer`` under ``root.common.engine`` — and the serving planes
(``weight_dtype``, ``kv_dtype`` under ``root.common.serving``), with
the same names and defaults as the JAX package.  Unlike the JAX
package it executes no site or user configuration file; the command
line applies config files and ``root.x=y`` overrides in argv order
(``__main__.apply_config_sources``), with ``root`` and :class:`Tune` in
scope; ``print_`` pretty-prints a node's tree (``--dump-config``).
:func:`override_scope` applies dotted-path leaf overrides for the
length of a ``with`` block and puts the prior leaves back after it (the
genetics, ensemble and population runs vary the tree per member with
it).
"""

import contextlib
import pprint

PROTECTED_KEYS = {"update", "print_", "keys", "items", "path_str",
                  "as_dict", "reset"}


class Tune(object):
    """Marks a config leaf as optimizable by the genetics subsystem:
    ``root.lr = Tune(0.01, 0.0001, 0.1)`` declares a gene with the
    given default and [min, max] range.  An untuned run reads the
    default."""

    def __init__(self, default, minv, maxv):
        self.default = default
        self.min = minv
        self.max = maxv

    def __repr__(self):
        return "Tune(%s, %s, %s)" % (self.default, self.min, self.max)

    def __float__(self):
        return float(self.default)

    def __int__(self):
        return int(self.default)


class Config(object):
    """A node in the configuration tree; attribute access vivifies
    intermediate nodes, so ``root.a.b.c = 1`` works without declaring
    ``a`` or ``b`` first."""

    def __init__(self, path="root"):
        object.__setattr__(self, "_path", path)

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        child = Config("%s.%s" % (self._path, name))
        object.__setattr__(self, name, child)
        return child

    def __setattr__(self, name, value):
        if name in PROTECTED_KEYS:
            raise AttributeError(
                "'%s' is a protected Config key" % name)
        if isinstance(value, dict) and not name.startswith("_"):
            node = Config("%s.%s" % (self._path, name))
            node.update(value)
            object.__setattr__(self, name, node)
        else:
            object.__setattr__(self, name, value)

    def update(self, tree=None, **kwargs):
        """Deep-merges a nested dict (or kwargs) into this node."""
        merged = dict(tree or {})
        merged.update(kwargs)
        for key, value in merged.items():
            if isinstance(value, dict):
                node = getattr(self, key)
                if not isinstance(node, Config):
                    node = Config("%s.%s" % (self._path, key))
                    object.__setattr__(self, key, node)
                node.update(value)
            else:
                setattr(self, key, value)
        return self

    def keys(self):
        return [k for k in self.__dict__ if not k.startswith("_")]

    def items(self):
        return [(k, v) for k, v in self.__dict__.items()
                if not k.startswith("_")]

    def as_dict(self):
        return {k: v.as_dict() if isinstance(v, Config) else v
                for k, v in self.items()}

    def path_str(self):
        return self._path

    def reset(self):
        """Drops every child from this node."""
        for k in self.keys():
            object.__delattr__(self, k)

    def get(self, name, default=None):
        """A *set* leaf value or ``default``; does not vivify."""
        value = self.__dict__.get(name, default)
        if isinstance(value, Config):
            return default
        return value

    def __contains__(self, name):
        return name in self.__dict__ and not name.startswith("_")

    def __repr__(self):
        return "<Config %s: %s>" % (self._path, sorted(self.keys()))

    def print_(self, file=None):
        """Pretty-prints the tree under this node (``--dump-config``)."""
        pprint.pprint(self.as_dict(), stream=file)


def get(value, default=None):
    """``default`` if ``value`` is an unset Config node, a
    :class:`Tune`'s default, else ``value``."""
    if isinstance(value, Config):
        return default
    if isinstance(value, Tune):
        return value.default
    return value


@contextlib.contextmanager
def override_scope(node, overrides):
    """Applies ``{dotted.path: value}`` leaf overrides under ``node`` and
    restores the exact prior leaves on exit: values that were set
    (``Tune`` objects included) are put back by object, and leaves that
    did not exist are deleted again.  Intermediate nodes vivified by the
    walk stay (an empty node reads as unset)."""
    saved = []  # (parent, leaf, existed, old value) in apply order
    try:
        for path, value in overrides.items():
            parts = path.split(".")
            parent = node
            for part in parts[:-1]:
                parent = getattr(parent, part)
            leaf = parts[-1]
            existed = leaf in parent.__dict__
            saved.append((parent, leaf, existed,
                          parent.__dict__.get(leaf)))
            setattr(parent, leaf, value)
        yield
    finally:
        for parent, leaf, existed, old in reversed(saved):
            if existed:
                object.__setattr__(parent, leaf, old)
            elif leaf in parent.__dict__:
                object.__delattr__(parent, leaf)


#: The global configuration root.
root = Config("root")

root.common.update({
    "engine": {
        # 0: bf16 activation stream; 1: f32; 2: f32 with the highest
        # matmul precision (float32 on the card with TF32 off).
        "precision_level": 0,
    },
    "loader": {
        "shuffle_limit": -1,
    },
    "serving": {
        # The decode programs' weight plane: "f32" or "int8"
        # (weight-only int8 matmuls, per-output-channel scales).
        "weight_dtype": "f32",
        # The paged KV pool's storage plane when the caller names none.
        "kv_dtype": "f32",
    },
})
