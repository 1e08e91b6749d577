"""numpy- and torch-aware JSON encoding.

Used by the serving endpoints and ``manifest.json`` — payloads
routinely contain numpy scalars/arrays and torch tensors that the
stdlib encoder rejects.
"""

import json

import numpy
import torch


class NumpyJSONEncoder(json.JSONEncoder):
    def default(self, obj):
        if isinstance(obj, numpy.integer):
            return int(obj)
        if isinstance(obj, numpy.floating):
            return float(obj)
        if isinstance(obj, numpy.bool_):
            return bool(obj)
        if isinstance(obj, numpy.ndarray):
            return obj.tolist()
        if isinstance(obj, torch.Tensor):
            return obj.detach().cpu().tolist()
        if hasattr(obj, "item") and not isinstance(obj, (str, bytes)):
            # Other array-library scalars and 0-d arrays.
            try:
                return obj.item()
            except (TypeError, ValueError):
                pass  # not a scalar after all: fall through
        if isinstance(obj, (set, frozenset)):
            return sorted(obj)
        try:
            return super(NumpyJSONEncoder, self).default(obj)
        except TypeError:
            # Config trees carry non-JSON leaves (Tune, callables) —
            # a readable repr beats failing the whole report/result.
            return repr(obj)


def dumps_json(obj, **kwargs):
    return json.dumps(obj, cls=NumpyJSONEncoder, **kwargs)


def dump_json(obj, path, **kwargs):
    """Writes ``obj`` as JSON to ``path`` (indented by default)."""
    kwargs.setdefault("indent", 2)
    with open(path, "w") as fout:
        json.dump(obj, fout, cls=NumpyJSONEncoder, **kwargs)
