"""Attribute-path configuration tree (the JAX package's ``config``).

An auto-vivifying attribute tree (``root.tinylm.n_blocks = 2``),
``update()`` from nested dicts and :func:`get`, which reads a leaf or a
default without vivifying it.  The port reads the engine knobs of the
training tick from it — ``remat``, ``attention_kernel``,
``attention_dtype``, ``fused_qkv``, ``precision_level`` and
``optimizer`` under ``root.common.engine`` — and the serving planes
(``weight_dtype``, ``kv_dtype`` under ``root.common.serving``), with
the same names and defaults as the JAX package.  Unlike the JAX
package it executes no site or user configuration file: the CLI
applies ``root.x=y`` overrides, and programs set leaves directly.
"""

PROTECTED_KEYS = {"update", "keys", "items", "path_str", "as_dict",
                  "reset"}


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


def get(value, default=None):
    """``default`` if ``value`` is an unset Config node, else
    ``value``."""
    if isinstance(value, Config):
        return default
    return value


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
