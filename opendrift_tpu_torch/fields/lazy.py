"""Lazy reader: defers construction until first use.

The port's copy of ``opendrift_tpu/fields/lazy.py`` (reference:
opendrift/readers/reader_lazy.py:23-82): wraps a constructor and its
arguments; any attribute access constructs the reader.  The port's
environment constructs it when it is added (its variables decide the
priority chains), so a failure to construct raises there.
"""

import logging

logger = logging.getLogger(__name__)


class LazyReader:
    def __init__(self, ctor, *args, name=None, **kwargs):
        self.__dict__["_ctor"] = ctor
        self.__dict__["_args"] = args
        self.__dict__["_kwargs"] = kwargs
        self.__dict__["_reader"] = None
        name = name or (args[0] if args else str(ctor))
        self.__dict__["name"] = f"LazyReader: {name}"
        self.__dict__["is_lazy"] = True
        self.__dict__["variables"] = None

    def initialise(self):
        if self._reader is None:
            logger.info("Initialising %s", self.name)
            self.__dict__["_reader"] = self._ctor(*self._args,
                                                  **self._kwargs)
            self.__dict__["is_lazy"] = False
            self.__dict__["name"] = self._reader.name
            self.__dict__["variables"] = self._reader.variables
        return self._reader

    def __getattr__(self, item):
        if item in ("_reader", "_ctor", "_args", "_kwargs"):
            return self.__dict__[item]
        reader = self.initialise()
        return getattr(reader, item)

    def __setattr__(self, key, value):
        if self.__dict__.get("_reader") is not None:
            setattr(self._reader, key, value)
        else:
            self.__dict__[key] = value

    def __repr__(self):
        if self._reader is None:
            return f"{self.name} (not yet initialised)"
        return repr(self._reader)
