"""Serving-side helpers shared by the engine templates.

Counterpart of ``predictionio_tpu/models/common.py`` (``DeviceCacheMixin``
only, so far).
"""

from __future__ import annotations


class DeviceCacheMixin:
    """Lazy per-instance device staging, rebuilt after unpickle.

    Cached device tensors live only in ``__dict__`` under their cache key
    (models define ``__getstate__``, so they are never pickled); ``_device``
    stages on first use, so a model pays the host→device transfer once, at
    warm() or its first query.
    """

    def _device(self, attr: str, build):
        dev = self.__dict__.get(attr)
        if dev is None:
            dev = build()
            self.__dict__[attr] = dev
        return dev
