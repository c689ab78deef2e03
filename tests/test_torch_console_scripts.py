"""The port's console scripts in ``pyproject.toml``: one ``rabbit-torch-*``
entry for every ``rabbit-*`` app of the JAX package, each resolving to a
callable ``main`` of the port's twin of that app (``rabbit-parse`` ->
``apps/parser.py`` in both)."""

import importlib
import os
import tomllib

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(ROOT, "pyproject.toml"), "rb") as _f:
    SCRIPTS = tomllib.load(_f)["project"]["scripts"]
JAX_APPS = sorted(k for k in SCRIPTS if not k.startswith("rabbit-torch-"))


def test_every_jax_app_has_a_torch_script():
    port = sorted(k for k in SCRIPTS if k.startswith("rabbit-torch-"))
    assert port == sorted("rabbit-torch-" + k[len("rabbit-"):]
                          for k in JAX_APPS)


@pytest.mark.parametrize("name", JAX_APPS)
def test_torch_script_resolves_to_the_twin_main(name):
    target = SCRIPTS["rabbit-torch-" + name[len("rabbit-"):]]
    module, func = target.split(":")
    ref_module = SCRIPTS[name].split(":")[0]
    assert module == ref_module.replace("rabbit_transcoding_tpu.",
                                        "rabbit_transcoding_tpu_torch.", 1)
    assert func == "main"
    assert callable(getattr(importlib.import_module(module), func))
