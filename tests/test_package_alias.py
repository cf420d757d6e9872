"""The package's former import name stays an alias of heat_cf: the same
module objects under both names, and ``python -m <alias>.main`` runs the
CLI. The alias packages are found at the repository root by what they
declare (``ALIAS_OF = heat_cf.__name__``)."""

import importlib
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _alias_packages():
    names = []
    for entry in sorted(os.listdir(REPO)):
        init = os.path.join(REPO, entry, "__init__.py")
        if os.path.isfile(init):
            with open(init) as fh:
                if "ALIAS_OF = heat_cf.__name__" in fh.read():
                    names.append(entry)
    return names


ALIASES = _alias_packages()


def test_an_alias_package_exists():
    assert ALIASES


@pytest.mark.parametrize("alias", ALIASES)
@pytest.mark.parametrize(
    "sub", ["", ".config", ".train.engine", ".serving", ".models.state"]
)
def test_alias_resolves_to_the_same_module(alias, sub):
    real = importlib.import_module("heat_cf" + sub)
    assert importlib.import_module(alias + sub) is real
    assert real.__spec__.name == "heat_cf" + sub  # its own spec, kept


@pytest.mark.parametrize("alias", ALIASES)
def test_alias_unknown_submodule_raises(alias):
    with pytest.raises(ModuleNotFoundError):
        importlib.import_module(alias + ".no_such_module")


@pytest.mark.parametrize("alias", ALIASES)
def test_alias_runs_the_cli_with_dash_m(alias):
    out = subprocess.run(
        [sys.executable, "-m", alias + ".main", "--help"], cwd=REPO,
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "JAX_PLATFORMS": "cpu"},
    )
    assert out.returncode == 0, out.stderr
    assert "--config" in out.stdout
