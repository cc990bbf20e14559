"""``parallel/distributed.py`` and the live mesh, on the CPU.

- ``initialize`` from the reference's ``MODELX_*`` variables and from
  torchrun's: two processes join one gloo group (the handshake), each
  reports its rank, the world and the backend its device picked.
- A single-process run is a no-op, as in the reference
  (``modelx_tpu/parallel/distributed.py``): the same ``process_span`` and
  ``host_local_slice``; in a 4-process group ``host_local_slice`` splits
  as the reference's formula does on 4 processes.
- The live mesh: each rank's coordinate equals the reference mesh's
  position of the device with that id, each axis group holds the ranks of
  the reference mesh's line through it, and the collectives sum, gather
  and broadcast what they should.

The group runs in ``tests/torch_mesh_util.py`` workers with a 60 s
timeout; the handshake subprocesses have a 120 s timeout.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

import torch_mesh_util as mu
from modelx_tpu.parallel import distributed as jdist
from modelx_tpu.parallel.mesh import make_mesh as jmake_mesh
from modelx_tpu_torch.parallel import distributed as tdist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = """
import json, torch.distributed as dist
from modelx_tpu_torch.parallel import distributed
joined = distributed.initialize(device="cpu", timeout_s=60)
out = {"joined": joined, "span": distributed.process_span(),
       "slice": distributed.host_local_slice(10), "backend": dist.get_backend(),
       "device": str(distributed.local_device())}
t = __import__("torch").tensor([dist.get_rank() + 1])
dist.all_reduce(t)
out["sum"] = int(t)
print(json.dumps(out), flush=True)
distributed.shutdown()
"""


def _env(extra: dict) -> dict:
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("MODELX_") and k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK",
                                                        "MASTER_ADDR", "MASTER_PORT")}
    env["PYTHONPATH"] = REPO
    env.update(extra)
    return env


def _run_pair(envs: list[dict]) -> list[dict]:
    import json

    procs = [subprocess.Popen([sys.executable, "-c", _CHILD], env=_env(e), cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for e in envs]
    out = []
    for p in procs:
        stdout, stderr = p.communicate(timeout=120)
        assert p.returncode == 0, stderr[-2000:]
        out.append(json.loads(stdout.strip().splitlines()[-1]))
    return out


@pytest.mark.parametrize("style", ["modelx", "torchrun"])
def test_two_processes_join_from_the_environment(style):
    port = mu.free_port()
    if style == "modelx":
        envs = [{"MODELX_COORDINATOR": f"127.0.0.1:{port}", "MODELX_NUM_PROCESSES": "2",
                 "MODELX_PROCESS_ID": str(r)} for r in range(2)]
    else:
        envs = [{"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port), "WORLD_SIZE": "2",
                 "RANK": str(r), "LOCAL_RANK": str(r)} for r in range(2)]
    out = _run_pair(envs)
    assert [o["span"] for o in out] == [[0, 2], [1, 2]]
    assert [o["slice"] for o in out] == [[0, 5], [5, 10]]
    assert all(o["joined"] and o["backend"] == "gloo" and o["device"] == "cpu"
               and o["sum"] == 3 for o in out)


def test_a_single_process_run_is_a_no_op(monkeypatch):
    for k in ("MODELX_COORDINATOR", "MODELX_NUM_PROCESSES", "MODELX_PROCESS_ID", "RANK",
              "WORLD_SIZE", "MASTER_ADDR"):
        monkeypatch.delenv(k, raising=False)
    assert tdist.initialize(device="cpu") is False
    assert tdist.process_span() == jdist.process_span() == (0, 1)
    for total in (0, 1, 7):
        assert tdist.host_local_slice(total) == jdist.host_local_slice(total)
    assert tdist.control_store() is None and str(tdist.local_device()) == "cpu"


def test_half_configured_or_missing_card_raises(monkeypatch):
    monkeypatch.delenv("MODELX_PROCESS_ID", raising=False)
    monkeypatch.delenv("RANK", raising=False)
    with pytest.raises(ValueError, match="process group needs"):
        tdist.initialize("127.0.0.1:1", 2, None, device="cpu")
    # a rank whose card is missing never moves to another card or the CPU
    with pytest.raises(RuntimeError, match=r"wants cuda:99, but this host has \d+ CUDA"):
        tdist.initialize("127.0.0.1:1", 2, 1, device="cuda:99")


@pytest.fixture(scope="module")
def group():
    g = mu.GlooGroup(4)
    yield g
    g.close()


def test_host_local_slice_in_a_group_follows_the_reference(group, monkeypatch):
    got = group.run(mu.host_slices, 10)
    want = []
    for r in range(4):
        monkeypatch.setattr(jdist, "process_span", lambda r=r: (r, 4))
        want.append(((r, 4), jdist.host_local_slice(10)))
    assert [(tuple(span), tuple(sl)) for span, sl in got] == want


@pytest.mark.parametrize("spec", ["dp=2,tp=2", "sp=2,tp=2", "tp=4", "dp=4", "dp=2,sp=2"])
def test_live_mesh_layout_equals_the_reference(group, spec):
    jm = jmake_mesh(spec, devices=__import__("jax").devices()[:4])
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    for rank, coord, groups in group.run(mu.mesh_layout, spec):
        pos = tuple(int(i) for i in np.argwhere(ids == rank)[0])
        assert coord == dict(zip(jm.axis_names, pos))
        for ax, axis in enumerate(jm.axis_names):
            line = ids[tuple(slice(None) if i == ax else p for i, p in enumerate(pos))]
            want = sorted(int(i) for i in np.ravel(line))
            assert (groups[axis] or [rank]) == want, (spec, rank, axis)


def test_collectives_over_a_live_mesh(group):
    out = group.run(mu.collectives, "dp=2,tp=2")
    for rank, (summed, gathered, leader) in enumerate(out):
        line = [rank - rank % 2, rank - rank % 2 + 1]  # this rank's tp pair
        assert summed == [float(sum(line))] * 2
        assert gathered == [line]
        assert leader == [10]
