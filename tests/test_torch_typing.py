"""Typing-surface gate of drtk_tpu_torch, as tests/test_typing.py is of
drtk_tpu: the port ships ``py.typed`` (PEP 561 inline typing), and every
public callable has a resolvable annotation for every parameter and for
its return value. No type-checker binary is available here, so this test
is the gate: ``typing.get_type_hints`` raises on a hint that names a
deleted or unimported type."""

import inspect
import pathlib
import typing

import pytest


def _public_callables():
    import drtk_tpu_torch as tt
    import drtk_tpu_torch.utils as ttu
    from drtk_tpu_torch.ops import filter2d

    out = []
    for mod, names in (
        (tt, [n for n in dir(tt) if not n.startswith("_")]),
        (ttu, [n for n in dir(ttu) if not n.startswith("_")]),
        (filter2d, list(getattr(filter2d, "__all__", []))),
    ):
        for n in names:
            obj = getattr(mod, n)
            if callable(obj) and not inspect.isclass(obj):
                out.append((f"{mod.__name__}.{n}", obj))
    seen, uniq = set(), []  # one case per function, however often it is exported
    for name, obj in out:
        key = getattr(obj, "__wrapped__", obj)
        if id(key) in seen:
            continue
        seen.add(id(key))
        uniq.append((name, obj))
    return uniq


@pytest.mark.parametrize("name,obj", _public_callables(), ids=[n for n, _ in _public_callables()])
def test_public_callable_fully_annotated(name, obj):
    hints = typing.get_type_hints(obj)  # raises if a hint cannot resolve
    sig = inspect.signature(obj)
    for p in sig.parameters.values():
        if p.kind in (p.VAR_POSITIONAL, p.VAR_KEYWORD):
            continue
        assert p.name in hints, f"{name}: parameter '{p.name}' unannotated"
    assert "return" in hints, f"{name}: return type unannotated"


def test_py_typed_marker_ships():
    import drtk_tpu_torch

    assert (pathlib.Path(drtk_tpu_torch.__file__).parent / "py.typed").exists()
