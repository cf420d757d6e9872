"""The package's former import name, kept as an alias of :mod:`heat_cf`.

Existing imports and ``python -m <this package>.main`` keep working: every
module imported under this name is the very module object of the same
name under ``heat_cf`` (one copy of each class and table, one pytree
registration). New code imports ``heat_cf``.
"""

import importlib
import importlib.abc
import importlib.util
import sys

import heat_cf

ALIAS_OF = heat_cf.__name__


class _AliasLoader(importlib.abc.Loader):
    def __init__(self, target: str):
        self.target = target

    def create_module(self, spec):
        module = importlib.import_module(self.target)
        self.spec = module.__spec__
        return module

    def exec_module(self, module):
        # The import system stamped the alias spec on the module; give it
        # back its own.
        module.__spec__ = self.spec

    def get_code(self, fullname):  # for ``python -m``
        return importlib.util.find_spec(self.target).loader.get_code(self.target)


class _AliasFinder(importlib.abc.MetaPathFinder):
    def find_spec(self, fullname, path, target=None):
        if not fullname.startswith(__name__ + "."):
            return None
        real = ALIAS_OF + fullname[len(__name__):]
        real_spec = importlib.util.find_spec(real)
        if real_spec is None:
            return None
        return importlib.util.spec_from_loader(
            fullname, _AliasLoader(real), origin=real_spec.origin
        )


sys.meta_path.insert(0, _AliasFinder())
sys.modules[__name__] = heat_cf
