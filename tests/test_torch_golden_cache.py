"""JAX goldens computed once per test session across pytest-xdist workers.

Under ``--dist load`` a module-scoped fixture runs once in every worker that
receives a test of its module, so a JAX golden that takes a minute to
compile would be paid by each of them, all at once on the same CPUs. The
port's test files instead call ``golden(tmp_path_factory, key, compute)``:

- outside xdist (``worker_id == "master"``) it returns ``compute()``;
- in a worker, the first caller computes under an exclusive ``fcntl.flock``
  on ``<key>.lock`` and pickles the result to ``<key>.pkl`` in the
  session's shared temporary directory (the parent of each worker's
  ``basetemp``, pytest-xdist's documented recipe); every other caller waits
  on the lock and reads the file.

Only numpy arrays, Python scalars and strings in plain dicts, lists and
tuples are cached: never a torch module or tensor, nor a JAX array, so that each
worker still builds the port's side itself.

``torch_threads`` is a module-scoped autouse fixture that the port's test
files import: it gives torch ``cpu_count // workers`` intra-op threads for
the module's tests (1 with 6 workers on 8 CPUs) and restores the count
after. torch's default of one OpenMP thread per CPU in every worker, each
spinning after its parallel regions, made a 10-step CPU training test take
100 s under 3 workers instead of 7 s.
"""

import fcntl
import os
import pickle
import threading
import time
from pathlib import Path
from typing import Any, Callable, Optional

import numpy as np
import pytest
import torch

_SCALARS = (bool, int, float, str, bytes, type(None), np.generic)


def _numpy_only(tree: Any, where: str = "golden") -> Any:
    """``tree`` itself, after checking that it holds numpy data only."""
    if type(tree) is dict:
        for k, v in tree.items():
            _numpy_only(v, f"{where}[{k!r}]")
    elif type(tree) in (list, tuple):  # not a NamedTuple of the JAX package
        for i, v in enumerate(tree):
            _numpy_only(v, f"{where}[{i}]")
    elif not isinstance(tree, (np.ndarray, *_SCALARS)):
        raise TypeError(f"{where}: only numpy data is cached, got {type(tree).__name__}")
    return tree


def cached(root: Optional[Path], key: str, compute: Callable[[], Any]) -> Any:
    """``compute()`` through the file cache under ``root`` (None: no cache)."""
    if root is None:
        return _numpy_only(compute())
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    path = root / f"{key}.pkl"
    with open(root / f"{key}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not path.exists():
                value = _numpy_only(compute())
                tmp = root / f"{key}.{os.getpid()}.tmp"
                with open(tmp, "wb") as f:
                    pickle.dump(value, f, protocol=pickle.HIGHEST_PROTOCOL)
                os.replace(tmp, path)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    with open(path, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    before = torch.get_num_threads()
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(before)


def golden(tmp_path_factory, key: str, compute: Callable[[], Any]) -> Any:
    """The session's one copy of a JAX golden (see the module docstring)."""
    if os.environ.get("PYTEST_XDIST_WORKER", "master") == "master":
        return cached(None, key, compute)
    return cached(tmp_path_factory.getbasetemp().parent / "torch_goldens", key, compute)


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((3, 4)).astype(np.float32),
            "b": [rng.integers(0, 9, 5), (1.5, "x")], "c": {"d": np.float32(2.0)}}


def test_second_read_returns_identical_arrays(tmp_path):
    calls = []

    def compute():
        calls.append(1)
        return _tree(0)

    first = cached(tmp_path, "t", compute)
    second = cached(tmp_path, "t", compute)
    assert len(calls) == 1
    want = _tree(0)
    for got in (first, second):
        np.testing.assert_array_equal(got["a"], want["a"])
        assert got["a"].dtype == np.float32
        np.testing.assert_array_equal(got["b"][0], want["b"][0])
        assert got["b"][1] == (1.5, "x") and got["c"]["d"] == np.float32(2.0)


def test_concurrent_reader_waits_instead_of_recomputing(tmp_path):
    """A second caller that arrives while the first computes blocks on the
    lock, then reads the first caller's result: one computation in all."""
    calls, results = [], {}
    started = threading.Event()

    def slow():
        calls.append("slow")
        started.set()
        time.sleep(0.5)
        return {"v": np.arange(4)}

    def fast():
        calls.append("fast")
        return {"v": np.zeros(4)}

    first = threading.Thread(target=lambda: results.setdefault("first", cached(tmp_path, "k", slow)))
    first.start()
    assert started.wait(10)
    t0 = time.perf_counter()
    results["second"] = cached(tmp_path, "k", fast)
    waited = time.perf_counter() - t0
    first.join()
    assert calls == ["slow"]
    assert waited > 0.2  # it blocked until the first caller was done
    np.testing.assert_array_equal(results["second"]["v"], np.arange(4))
    np.testing.assert_array_equal(results["first"]["v"], np.arange(4))


def test_outside_xdist_computes_directly(tmp_path_factory, monkeypatch):
    monkeypatch.delenv("PYTEST_XDIST_WORKER", raising=False)
    calls = []
    for _ in range(2):
        golden(tmp_path_factory, "direct", lambda: calls.append(1) or {"x": np.ones(2)})
    assert len(calls) == 2


def test_torch_threads_follow_the_worker_count():
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    assert torch.get_num_threads() == max(1, (os.cpu_count() or 1) // workers)


@pytest.mark.parametrize("bad", [
    {"m": torch.zeros(2)},
    [torch.nn.Linear(2, 2)],
    {"nt": __import__("collections").namedtuple("Out", "a")(np.ones(1))},
])
def test_anything_but_numpy_is_refused(tmp_path, bad):
    with pytest.raises(TypeError, match="only numpy"):
        cached(tmp_path, "bad", lambda: bad)
    assert not (tmp_path / "bad.pkl").exists()
