"""Former name of the `abip` package, kept so that existing code runs.

Importing this package, or any ``<this package>.<module>`` below it,
returns the very module object of ``abip`` / ``abip.<module>``: one copy
of each module, so classes, caches and jitted functions are shared.
"""
import importlib
import importlib.abc
import importlib.util
import sys

import abip

_PREFIX = __name__ + "."


class _Alias(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    """Resolves ``<this package>.<module>`` to ``abip.<module>``."""

    def find_spec(self, fullname, path=None, target=None):
        if not fullname.startswith(_PREFIX):
            return None
        return importlib.util.spec_from_loader(fullname, self)

    def create_module(self, spec):
        module = importlib.import_module("abip." + spec.name[len(_PREFIX):])
        spec.loader_state = module.__spec__
        return module

    def exec_module(self, module):
        # the import machinery stamped the alias spec on the shared module
        module.__spec__ = module.__spec__.loader_state


sys.meta_path.insert(0, _Alias())
sys.modules[__name__] = abip
