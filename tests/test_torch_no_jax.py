"""adrates_torch must run where JAX is not installed: it imports no JAX,
directly or through adrates_tpu; and where pandas is not installed: it
imports pandas only inside the result types' DataFrame views."""

import json
import pathlib
import re
import subprocess
import sys

import pytest

PKG = pathlib.Path(__file__).resolve().parent.parent / "adrates_torch"
MODULES = sorted(
    ".".join(p.relative_to(PKG.parent).with_suffix("").parts)
    .replace(".__init__", "")
    for p in PKG.rglob("*.py"))


_PROBE = """
import importlib, json, sys
sys.modules['jax'] = None
sys.modules['adrates_tpu'] = None
sys.modules['pandas'] = None
out = {}
for m in sys.argv[1:]:
    try:
        importlib.import_module(m)
        out[m] = ''
    except Exception as e:  # reported per module by the test below
        out[m] = repr(e)
leaked = [m for m, v in sys.modules.items()
          if v is not None and (m == 'jax' or m.startswith('jax.'))]
print(json.dumps(dict(errors=out, leaked=leaked)))
"""


@pytest.fixture(scope="module")
def blocked_imports():
    """Import every module of the package in ONE fresh interpreter with
    jax, adrates_tpu and pandas blocked."""
    res = subprocess.run([sys.executable, "-c", _PROBE, *MODULES],
                         capture_output=True, text=True,
                         cwd=str(PKG.parent), timeout=300)
    assert res.returncode == 0, res.stderr
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("module", MODULES)
def test_imports_with_jax_blocked(blocked_imports, module):
    assert blocked_imports["errors"][module] == ""
    assert blocked_imports["leaked"] == []


def test_no_jax_import_in_sources():
    pat = re.compile(r"^\s*(import jax|from jax|import adrates_tpu|"
                     r"from adrates_tpu)", re.M)
    offenders = [str(p) for p in PKG.rglob("*.py")
                 if pat.search(p.read_text())]
    assert offenders == []


def test_no_global_default_dtype():
    offenders = [str(p) for p in PKG.rglob("*.py")
                 if "set_default_dtype" in p.read_text()]
    assert offenders == []
