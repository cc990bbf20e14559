"""pytest plugin: run the suite under the port's lockdep when ``MODELX_LOCKDEP=1``.

Loaded on the command line (``make chaos-torch``)::

    MODELX_LOCKDEP=1 python -m pytest -p modelx_tpu_torch.analysis.pytest_lockdep \\
        tests/test_torch_*.py -m chaos

When the env var is unset the plugin does nothing (no patching, zero
overhead). When set, ``threading.Lock``/``RLock`` are instrumented at
configure time (before test modules import), a summary is printed at the
end, and any lock-order CYCLE fails the session — a potential deadlock
observed in a real interleaving is a bug even if this run got lucky.
Over-threshold holds are reported but do not fail (they are load- and
machine-dependent; the lint + drills decide what to chase).

**Two plugins, one graph.** ``tests/conftest.py`` registers the JAX
package's plugin, which installs ITS lockdep under the same
``MODELX_LOCKDEP=1``. Both patch ``threading.Lock``: the later install
would wrap the earlier one's factory, each graph would see a different
set of locks, and two reports would each decide the exit code. So this
plugin's ``pytest_configure`` is ``tryfirst``: it runs before every plain
``pytest_configure`` (the other plugin's included, whatever the load
order), installs the port's graph, and takes ``MODELX_LOCKDEP`` out of
the environment until ``pytest_sessionstart``. The other plugin then
finds lockdep off and installs nothing. At session start the variable is
restored (test subprocesses and xdist workers see it), and the plugin
checks that ``threading.Lock`` is still its own factory — a lockdep
installed behind its back is a usage error, not a silent double wrap.
The graph hangs off its own config attribute, so the other plugin's
summary and exit-status hooks find nothing to report.
"""

from __future__ import annotations

import os

import pytest

from modelx_tpu_torch.analysis import lockdep

_GRAPH_ATTR = "_modelx_torch_lockdep_graph"
_HIDDEN_ATTR = "_modelx_torch_lockdep_hidden_env"


@pytest.hookimpl(tryfirst=True)
def pytest_configure(config) -> None:
    graph = lockdep.install_from_env()
    if graph is not None:
        setattr(config, _GRAPH_ATTR, graph)
        # hidden until the session starts, after every plugin configured
        setattr(config, _HIDDEN_ATTR, os.environ.pop(lockdep.ENV_VAR))


@pytest.hookimpl(tryfirst=True)
def pytest_sessionstart(session) -> None:
    config = session.config
    hidden = getattr(config, _HIDDEN_ATTR, None)
    if hidden is not None:
        os.environ[lockdep.ENV_VAR] = hidden
        setattr(config, _HIDDEN_ATTR, None)
    if getattr(config, _GRAPH_ATTR, None) is not None and not lockdep.owns_factories():
        raise pytest.UsageError(
            "modelx_tpu_torch lockdep: threading.Lock was patched again after "
            "the port's lockdep installed; exactly one lockdep may instrument "
            "a run")


def pytest_terminal_summary(terminalreporter, exitstatus, config) -> None:
    graph = getattr(config, _GRAPH_ATTR, None)
    if graph is None:
        return
    terminalreporter.section("modelx_tpu_torch lockdep")
    terminalreporter.write_line(graph.render_report())


def pytest_sessionfinish(session, exitstatus) -> None:
    graph = getattr(session.config, _GRAPH_ATTR, None)
    if graph is None:
        return
    if graph.cycles and exitstatus == 0:
        # a lock-order cycle is a deadlock that hasn't happened yet
        session.exitstatus = 1
