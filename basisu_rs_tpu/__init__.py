"""Former name of the `basisu_rs_jax` package, kept so that existing imports
and `python -m` invocations go on working.  Importing it warns once; it and
every submodule under it are the very module objects of `basisu_rs_jax`."""

import importlib
import importlib.abc
import importlib.util
import sys
import warnings

import basisu_rs_jax
from basisu_rs_jax import *  # noqa: F401,F403
from basisu_rs_jax import __all__, __version__  # noqa: F401

_NEW = basisu_rs_jax.__name__


class _Alias(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    """Loads `<former name>.x.y` as `basisu_rs_jax.x.y`."""

    def find_spec(self, fullname, path=None, target=None):
        if fullname.startswith(__name__ + ".") and fullname != __name__ + ".__main__":
            return importlib.util.spec_from_loader(fullname, self)
        return None

    def create_module(self, spec):
        return None

    def exec_module(self, module):
        # the import system re-reads sys.modules after exec_module, so the
        # alias resolves to the real module and its __spec__ stays its own
        sys.modules[module.__name__] = importlib.import_module(_NEW + module.__name__[len(__name__):])


sys.meta_path.insert(0, _Alias())
warnings.warn(f"{__name__} is now {_NEW}; import {_NEW} instead",
              DeprecationWarning, stacklevel=2)
