"""Sweep the port's parity checks across MKL sgemm paths and JAX caches,
reading how close each float comparison comes to its limit.

A pytest plugin and a script in one file (not collected: no test_ prefix).

    python tests/parity_sweep.py run SETTING OUT [--root DIR] [--workers N]
        [--files tests/test_torch_x.py ...]
    python tests/parity_sweep.py table OUT...
    python tests/parity_sweep.py first-exp [--threads N]

`run` runs every tests/test_torch_*.py that imports the JAX package
(under DIR's tests/, default this checkout) with JAX on the CPU under
SETTING ("default"; "compatible" = MKL_CBWR=COMPATIBLE; "avx2" =
MKL_ENABLE_INSTRUCTIONS=AVX2; any other name runs as "default", e.g.
"cold" from a `git archive` copy whose .jax_cache starts empty), with
`-p xdist -n N --dist loadfile` and this file loaded as a plugin, and
writes OUT/records-*.jsonl, OUT/pytest.log and fresh bytecode under
OUT/pyc (pytest must rewrite the asserts again for the pass hook).
`table` merges the runs of several OUT directories into one markdown
table of every comparison that failed, or passed above half its limit,
in any of them, with each setting's value over the limit.

What the plugin reads, for each call in a test or in torch_port_util:
  - numpy.testing.assert_allclose: max |a - b| / (atol + rtol |b|);
  - pytest.approx: |a - b| / the approx's tolerance;
  - an assert holding `x < y` or `x <= y` (also inside `and`, chained,
    `(x <= y).all()` and the like) whose x is >= 0 and y > 0: max x / y;
    one holding a share `s > f` or `s >= f` with f in (0.5, 1) (e.g.
    `(d <= band).mean() > 0.99`): (1 - s) / (1 - f); both sides evaluated
    again in the asserting frame (a passing assert);
  - a failed test: its nodeid and the first line of its message (a
    failing assert's values are in it).
It does not read exact comparisons, other lower bounds, or a `<` / `<=`
whose left side can be negative.

`first-exp` looks for ROADMAP's W3 under each MKL setting: in a fresh
process that has imported JAX and run a JAX computation on the CPU, the
first multi-threaded `torch.exp` of 2^20 seeded normals against a second
call (bits) and against numpy's f64 exp (f32 ulps)."""
import ast
import glob
import json
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
MKL_VARS = ("MKL_CBWR", "MKL_ENABLE_INSTRUCTIONS")

_out = None          # this process's records file, when the sweep is on
_test = None         # the nodeid of the running test


def _write(rec: dict) -> None:
    rec["test"] = _test
    _out.write(json.dumps(rec) + "\n")
    _out.flush()


def _site():
    """(frame, "file:line") of the innermost caller under tests/ that is
    not this file."""
    f = sys._getframe(1)
    while f is not None:
        fn = f.f_code.co_filename
        if os.path.dirname(os.path.abspath(fn)) == HERE and \
                os.path.basename(fn) != "parity_sweep.py":
            return f, f"{os.path.basename(fn)}:{f.f_lineno}"
        f = f.f_back
    return None, "?"


def _as_f64(x):
    if hasattr(x, "detach"):
        x = x.detach().cpu().double().numpy()
    return np.asarray(x, dtype=np.float64)


def _ratio(gap, limit) -> float:
    """max over entries of gap / limit (0 where the gap is 0)."""
    gap, limit = np.broadcast_arrays(_as_f64(gap), _as_f64(limit))
    with np.errstate(divide="ignore", invalid="ignore"):
        r = np.where(gap == 0, 0.0, gap / limit)
    r = r[~np.isnan(r)]
    return float(r.max()) if r.size else 0.0


def _wrap_allclose():
    orig = np.testing.assert_allclose

    def assert_allclose(actual, desired, rtol=1e-7, atol=0, equal_nan=True,
                        err_msg="", verbose=True, **kw):
        try:
            a, d = _as_f64(actual), _as_f64(desired)
            both = np.isnan(a) & np.isnan(d) | (a == d)
            gap = np.where(both, 0.0, np.abs(a - d))
            ratio = _ratio(gap, atol + rtol * np.abs(d))
            _, site = _site()
            _write({"kind": "allclose", "site": site,
                    "yardstick": f"assert_allclose rtol={rtol:g} "
                                 f"atol={atol:g}",
                    "ratio": ratio})
        except (TypeError, ValueError):
            pass
        return orig(actual, desired, rtol=rtol, atol=atol, equal_nan=equal_nan,
                    err_msg=err_msg, verbose=verbose, **kw)

    np.testing.assert_allclose = assert_allclose


def _wrap_approx():
    from _pytest import python_api
    orig = python_api.ApproxScalar.__eq__

    def __eq__(self, actual):
        try:
            tol = float(self.tolerance)
            gap = abs(float(actual) - float(self.expected))
            _, site = _site()
            _write({"kind": "approx", "site": site,
                    "yardstick": f"approx rel={self.rel} abs={self.abs}",
                    "ratio": 0.0 if gap == 0 else gap / tol})
        except (TypeError, ValueError, ZeroDivisionError):
            pass
        return orig(self, actual)

    python_api.ApproxScalar.__eq__ = __eq__


REDUCTIONS = ("mean", "sum", "any")


def _comparisons(tree):
    """(kind, left, right) of every `<` / `<=` ("bound") and every `>` /
    `>=` ("floor") in an assert, but for a comparison reduced by `.mean()`,
    `.sum()` or `.any()` (a share or a count: its floor is the check)."""
    reduced = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute) and node.attr in REDUCTIONS:
            reduced.add(id(node.value))
        if isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in REDUCTIONS:
            reduced.update(id(a) for a in node.args)
    for node in ast.walk(tree):
        if isinstance(node, ast.Compare) and id(node) not in reduced:
            sides = [node.left] + list(node.comparators)
            for i, op in enumerate(node.ops):
                if isinstance(op, (ast.Lt, ast.LtE)):
                    yield "bound", sides[i], sides[i + 1]
                elif isinstance(op, (ast.Gt, ast.GtE)):
                    yield "floor", sides[i], sides[i + 1]


def pytest_configure(config):
    global _out
    out = os.environ.get("PARITY_SWEEP_OUT")
    if not out:
        return
    import pytest
    pytest.register_assert_rewrite("torch_port_util")
    worker = os.environ.get("PYTEST_XDIST_WORKER", "main")
    _out = open(os.path.join(out, f"records-{worker}.jsonl"), "a")
    _wrap_allclose()
    _wrap_approx()


def pytest_runtest_logstart(nodeid, location):
    global _test
    _test = nodeid


def pytest_assertion_pass(item, lineno, orig, expl):
    if _out is None:
        return
    frame, site = _site()
    if frame is None:
        return
    try:
        tree = ast.parse(orig.strip(), mode="eval")
    except SyntaxError:
        return
    env = dict(frame.f_globals, **frame.f_locals)
    for kind, left, right in _comparisons(tree):
        try:
            lv, rv = (_as_f64(eval(compile(ast.Expression(e), "<sweep>",
                                           "eval"), env))
                      for e in (left, right))
        except Exception as err:     # noqa: BLE001  (any expression)
            _write({"kind": "unread", "site": site,
                    "yardstick": ast.unparse(left) + " ? "
                    + ast.unparse(right), "error": repr(err)[:200],
                    "ratio": 0.0})
            continue
        if kind == "bound":
            if lv.size == 0 or (lv < 0).any() or not (rv > 0).all():
                continue
            ratio, text = _ratio(lv, rv), f"{ast.unparse(left)} <= " \
                f"{ast.unparse(right)}"
        else:
            # a share held above a floor in (0.5, 1): the share outside
            # over what the floor leaves outside
            if lv.size != 1 or rv.size != 1 or not 0.5 < rv < 1 or \
                    not 0 <= lv <= 1:
                continue
            ratio, text = float((1 - lv) / (1 - rv)), \
                f"{ast.unparse(left)} >= {ast.unparse(right)}"
        _write({"kind": kind, "site": site, "yardstick": text,
                "ratio": ratio})


def pytest_runtest_logreport(report):
    if _out is not None and report.failed:
        msg = str(getattr(report.longrepr, "reprcrash", None) and
                  report.longrepr.reprcrash.message or report.longrepr)
        _out.write(json.dumps({"test": report.nodeid, "failed": True,
                               "message": msg.splitlines()[0][:300]}) + "\n")
        _out.flush()


def jax_files(root: str) -> list:
    """tests/test_torch_*.py of `root` that import the JAX package."""
    out = []
    for p in sorted(glob.glob(os.path.join(root, "tests", "test_torch_*.py"))):
        text = open(p).read()
        if "vtgaussian_slam_tpu." in text or "import jax" in text:
            out.append(os.path.relpath(p, root))
    return out


def settings() -> dict:
    """{setting: the MKL variables it sets}: the default path and
    torch_port_util.MKL_PATHS (imported here, not when pytest loads this
    file as a plugin: torch_port_util must be imported after its asserts
    are registered for rewriting)."""
    from torch_port_util import MKL_PATHS
    return {"default": {}, **MKL_PATHS}


def run(setting: str, out: str, root: str, workers: int,
        files: list | None = None) -> int:
    out = os.path.abspath(out)
    os.makedirs(out, exist_ok=True)
    for p in glob.glob(os.path.join(out, "records-*.jsonl")):
        os.remove(p)
    extra = settings().get(setting, {})
    env = {k: v for k, v in os.environ.items() if k not in MKL_VARS}
    env.update(extra, JAX_PLATFORMS="cpu",
               PARITY_SWEEP_OUT=out,
               PYTHONPYCACHEPREFIX=os.path.join(out, "pyc"),
               PYTHONPATH=os.path.join(root, "tests"))
    cmd = [sys.executable, "-m", "pytest", *(files or jax_files(root)),
           "-q", "-rf",
           "-p", "no:cacheprovider", "-p", "xdist", "-n", str(workers),
           "--dist", "loadfile", "-p", "parity_sweep",
           "-o", "enable_assertion_pass_hook=true"]
    with open(os.path.join(out, "pytest.log"), "w") as log:
        log.write(json.dumps({"setting": setting, "root": root,
                              "env": extra}) + "\n")
        log.flush()
        return subprocess.call(cmd, cwd=root, env=env, stdout=log,
                               stderr=subprocess.STDOUT)


def _load(out: str):
    """({(function, site, yardstick): (max ratio, its nodeid)}, failed,
    comparisons it could not evaluate again)."""
    rows, failed, unread = {}, {}, set()
    for p in glob.glob(os.path.join(out, "records-*.jsonl")):
        for line in open(p):
            r = json.loads(line)
            if r.get("failed"):
                failed[r["test"]] = r["message"]
                continue
            if r["kind"] == "unread":
                unread.add((r["site"], r["yardstick"]))
                continue
            func = (r["test"] or "?").split("[")[0]
            key = (func, r["site"], r["yardstick"])
            if key not in rows or r["ratio"] > rows[key][0]:
                rows[key] = (r["ratio"], r["test"])
    return rows, failed, unread


def table(outs: list) -> None:
    names = [os.path.basename(os.path.normpath(o)) for o in outs]
    loaded = [_load(o) for o in outs]
    keys = sorted(set().union(*(rows for rows, _, _ in loaded)))
    for name, (rows, failed, unread) in zip(names, loaded):
        print(f"{name}: {len(rows)} comparisons read, {len(unread)} not "
              f"evaluated again {sorted(unread)}, {len(failed)} failed "
              f"tests {sorted(failed)}")
    print()
    print("| test | site | yardstick | " + " | ".join(names) + " |")
    print("|---|---|---|" + "---|" * len(names))
    for key in keys:
        vals = [rows.get(key, (None, None))[0] for rows, _, _ in loaded]
        if not any(v is not None and v > 0.5 for v in vals):
            continue
        cells = [("-" if v is None else f"{v:.3g}") for v in vals]
        print(f"| {key[0]} | {key[1]} | `{key[2][:70]}` | "
              + " | ".join(cells) + " |")
    for name, (_, failed, _) in zip(names, loaded):
        for t, msg in sorted(failed.items()):
            print(f"FAILED under {name}: {t}: {msg}")


FIRST_EXP = """
import json, sys
import jax.numpy as jnp
import numpy as np
import torch
torch.set_num_threads({threads})
float(jnp.exp(jnp.arange(8.0)).sum())
x = torch.as_tensor(np.random.default_rng(0).standard_normal(1 << 20,
                                                             np.float32))
first, second = torch.exp(x).numpy(), torch.exp(x).numpy()
ref = np.exp(x.numpy().astype(np.float64))
ulp = np.abs(first - ref) / np.spacing(ref.astype(np.float32))
print(json.dumps({{"threads": torch.get_num_threads(),
                  "differ_from_second": int((first != second).sum()),
                  "max_ulp_first": float(ulp.max()),
                  "max_ulp_second": float((np.abs(second - ref) / np.spacing(
                      ref.astype(np.float32))).max())}}))
"""


def first_exp(threads: int) -> None:
    for setting, extra in settings().items():
        env = {k: v for k, v in os.environ.items() if k not in MKL_VARS}
        env.update(extra, JAX_PLATFORMS="cpu")
        run = subprocess.run([sys.executable, "-c",
                              FIRST_EXP.format(threads=threads)], env=env,
                             capture_output=True, text=True)
        print(setting, run.stdout.strip().splitlines()[-1:] or
              run.stderr[-2000:])


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("run")
    r.add_argument("setting")
    r.add_argument("out")
    r.add_argument("--root", default=os.path.dirname(HERE))
    r.add_argument("--workers", type=int, default=6)
    r.add_argument("--files", nargs="*", help="default: every file that "
                   "imports the JAX package")
    t = sub.add_parser("table")
    t.add_argument("outs", nargs="+")
    f = sub.add_parser("first-exp")
    f.add_argument("--threads", type=int, default=os.cpu_count())
    a = ap.parse_args()
    if a.cmd == "first-exp":
        first_exp(a.threads)
        sys.exit(0)
    if a.cmd == "run":
        sys.exit(run(a.setting, a.out, os.path.abspath(a.root), a.workers,
                     a.files))
    table(a.outs)
