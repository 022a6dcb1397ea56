"""A call recorder around ``tests/fake_scenepic.py``, for the port's
scenepic tests: every class built, method called and attribute set
through it is logged as (name, arguments), so two packages' scenes can
be held equal call by call. NOT a test module."""

import types

import numpy as np

import fake_scenepic


def _plain(value):
    """A logged argument: arrays (NumPy, JAX, torch) as float64 or
    their own integer/bool NumPy arrays, recorded objects by their class
    name, containers element by element."""
    if isinstance(value, _Recorded):
        return f"<{value._name}>"
    if isinstance(value, dict):
        return {k: _plain(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_plain(v) for v in value)
    if hasattr(value, "__array__") and not isinstance(value, (str, bytes)):
        array = np.asarray(value)
        return array.astype(np.float64) if array.dtype.kind == "f" else array
    return value


def _target(value):
    return value._target if isinstance(value, _Recorded) else value


class _Recorded:
    """A fake scenepic object (or class) whose calls are logged."""

    def __init__(self, target, name, log):
        object.__setattr__(self, "_target", target)
        object.__setattr__(self, "_name", name)
        object.__setattr__(self, "_log", log)

    def _wrap(self, result):
        if isinstance(result, tuple(_CLASSES)):
            return _Recorded(result, type(result).__name__, self._log)
        return result

    def __call__(self, *args, **kwargs):
        self._log.append((self._name, _plain(args), _plain(kwargs)))
        result = self._target(*[_target(a) for a in args],
                              **{k: _target(v) for k, v in kwargs.items()})
        return self._wrap(result)

    def __getattr__(self, attr):
        value = getattr(self._target, attr)
        name = f"{self._name}.{attr}"
        if isinstance(value, type) or callable(value):
            return _Recorded(value, name, self._log)
        return value

    def __setattr__(self, attr, value):
        self._log.append((f"{self._name}.{attr} =", _plain(value), {}))
        setattr(self._target, attr, _target(value))


_CLASSES = [v for v in vars(fake_scenepic).values() if isinstance(v, type)]


def recording_scenepic():
    """(a ``scenepic`` module for ``sys.modules``, its call log)."""
    log = []
    module = types.ModuleType("scenepic")
    for name, value in vars(fake_scenepic).items():
        if isinstance(value, type):
            setattr(module, name, _Recorded(value, name, log))
    return module, log


def assert_same_calls(ours, ref, rtol=1e-5, atol=1e-6):
    """The two logs name the same calls in the same order, with equal
    scalars and strings and arrays within the f32 tolerance."""
    assert [entry[0] for entry in ours] == [entry[0] for entry in ref]
    for mine, theirs in zip(ours, ref):
        _assert_same(mine[1:], theirs[1:], mine[0], rtol, atol)


def _assert_same(mine, theirs, where, rtol, atol):
    if isinstance(theirs, np.ndarray) or isinstance(mine, np.ndarray):
        mine, theirs = np.asarray(mine), np.asarray(theirs)
        assert mine.shape == theirs.shape, (where, mine.shape, theirs.shape)
        np.testing.assert_allclose(mine, theirs, rtol=rtol, atol=atol,
                                   err_msg=where)
    elif isinstance(theirs, dict):
        assert sorted(mine) == sorted(theirs), where
        for key in theirs:
            _assert_same(mine[key], theirs[key], where, rtol, atol)
    elif isinstance(theirs, (list, tuple)):
        assert len(mine) == len(theirs), where
        for a, b in zip(mine, theirs):
            _assert_same(a, b, where, rtol, atol)
    elif isinstance(theirs, float):
        assert np.isclose(mine, theirs, rtol=rtol, atol=atol), where
    else:
        assert mine == theirs, (where, mine, theirs)
