"""One rank per process in the port (``parallel/distributed.py``), on the CPU.

The JAX package's ``tests/test_distributed.py`` five cases against the
port's module (the inventory's forms, malformed entries, the coordinates,
the launch plan with torch's variable names, a 2-rank ``launch_local``
self-test under gloo), then what the port adds: the backend is explicit
(nccl with two ranks on one card raises before the group is made, nothing
falls back), no cluster variables means no cluster, a rank that fails ends
the cluster at once, a mesh across ranks says so, and each fleet backend
sees a card of its own.
"""

import subprocess
import time

import pytest
import torch

from cuda_mpi_gpu_cluster_programming_tpu_torch.parallel import distributed
from cuda_mpi_gpu_cluster_programming_tpu_torch.parallel.distributed import (
    BACKEND_ENV,
    ClusterConfig,
    HostSpec,
    launch_local,
    launch_plan,
)
from cuda_mpi_gpu_cluster_programming_tpu_torch.serving.fleet import BackendFleet
from torch_threads import one_intra_op_thread  # noqa: unused-import (an autouse fixture)

CLUSTER_VARS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE", BACKEND_ENV)


@pytest.fixture
def no_cluster(monkeypatch):
    for var in CLUSTER_VARS:
        monkeypatch.delenv(var, raising=False)


def test_hostspec_parse_forms():
    h = HostSpec.parse("alice@10.0.0.2 h100")
    assert (h.user, h.host, h.arch) == ("alice", "10.0.0.2", "h100")
    assert h.ssh_target == "alice@10.0.0.2"
    bare = HostSpec.parse("node1")
    assert (bare.user, bare.host, bare.arch) == (None, "node1", "h100")
    assert bare.ssh_target == "node1"


def test_hostspec_parse_malformed():
    with pytest.raises(ValueError, match="malformed"):
        HostSpec.parse("a b c")
    with pytest.raises(ValueError, match="malformed"):
        HostSpec.parse("")


def test_cluster_coordinates():
    c = ClusterConfig.parse(["alice@m1 h100", "alice@m2 h100"], port=1234)
    assert c.coordinator_address == "m1:1234"
    assert c.num_processes == 2
    assert ClusterConfig.parse(["m1"]).coordinator_address == f"m1:{distributed.DEFAULT_COORDINATOR_PORT}" == "m1:9911"


def test_launch_plan_shape():
    c = ClusterConfig.parse(["alice@m1", "bob@m2"])
    cmds = launch_plan(c, "pkg.run", ["--config", "v1_jit"], workdir="/w", backend="gloo")
    assert len(cmds) == 2
    assert not cmds[0].startswith("ssh")  # host 0 = master runs locally
    assert cmds[1].startswith("ssh bob@m2 ")
    assert "RANK=1" in cmds[1] and "RANK=0" in cmds[0]
    assert "WORLD_SIZE=2" in cmds[1]
    assert "MASTER_ADDR=m1 MASTER_PORT=9911" in cmds[1]
    assert f"{BACKEND_ENV}=gloo" in cmds[0] and f"{BACKEND_ENV}=gloo" in cmds[1]
    assert "--config v1_jit" in cmds[0] and "cd /w" in cmds[0]
    assert BACKEND_ENV not in launch_plan(c, "pkg.run")[0]


def test_localhost_cluster_end_to_end():
    """The self-test over 2 ranks x 2 slots under gloo: n(n+1)/2 over the 4
    global slots, the inner axis inside each process."""
    results = launch_local(2, slots_per_process=2, device="cpu", backend="gloo", module_args=["--device", "cpu"],
                           timeout_s=120)
    for rank, r in enumerate(results):
        assert r.returncode == 0, r.stdout
        assert f"rank={rank}: processes=2 global_slots=4 slots_per_process=2 backend=gloo" in r.stdout
        assert "psum=10.0 expect=10.0 -> PASSED" in r.stdout


def test_without_cluster_variables_nothing_joins(no_cluster):
    assert distributed.maybe_initialize_from_env(device="cpu") is False
    assert not distributed.is_distributed()
    mesh = distributed.make_multihost_mesh(2, device="cpu")
    assert mesh.owners is None and mesh.shape == (1, 2) and mesh.axis_names == ("dp", "sp")
    assert distributed.default_backend("cpu") == "gloo" and distributed.default_backend("cuda") == "nccl"


def test_nccl_with_two_ranks_on_one_card_raises_before_init(no_cluster, monkeypatch):
    """NCCL refuses two ranks on one card, so the port refuses first, naming
    gloo; nothing falls back from nccl to gloo or from the card to the CPU."""
    def never(*_a, **_k):
        raise AssertionError("init_process_group reached")

    monkeypatch.setattr(torch.distributed, "init_process_group", never)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="nccl refuses two ranks on one card.*gloo"):
        distributed.maybe_initialize_from_env(backend="nccl")
    with pytest.raises(ValueError, match="nccl refuses two ranks on one card"):
        launch_local(2, device="cuda", backend="nccl")
    with pytest.raises(ValueError, match="a CPU cluster runs under gloo"):
        distributed.initialize(backend="nccl", device="cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        distributed.initialize(backend="mpi", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed.initialize(backend="gloo", device="cuda")


def test_a_rank_that_fails_ends_the_cluster():
    """Rank 1 raises before its first collective; rank 0 would wait for it
    in the group's next one (its timeout is minutes): the launcher kills it
    at rank 1's exit, well inside the cluster's deadline."""
    t0 = time.monotonic()
    results = launch_local(2, module="tests.torch_dist_tiers", module_args=["--out", ".", "--shards", "2",
                                                                          "--fail-rank", "1"],
                           device="cpu", timeout_s=120)
    assert time.monotonic() - t0 < 60
    assert results[1].returncode != 0 and "rank 1 fails before its first collective" in results[1].stdout
    assert results[0].returncode != 0  # killed, not finished


def test_a_hung_cluster_is_killed_at_its_deadline():
    t0 = time.monotonic()
    with pytest.raises(subprocess.TimeoutExpired):
        launch_local(1, module="tests.torch_dist_tiers", module_args=["--out", ".", "--shards", "1",
                                                                      "--hang-rank", "0"],
                     device="cpu", timeout_s=3.0)
    assert time.monotonic() - t0 < 30


def test_a_mesh_across_ranks_says_where_its_slots_are(monkeypatch):
    """A process group of 2 (faked: its size and rank) gives each rank a
    contiguous run of slots on its own device, the others' on meta; the
    describe line names the ranks, the slots and the backend."""
    from cuda_mpi_gpu_cluster_programming_tpu_torch.parallel import mesh as tmesh

    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 2)
    monkeypatch.setattr(torch.distributed, "get_rank", lambda: 1)
    monkeypatch.setattr(torch.distributed, "get_backend", lambda: "gloo")
    m = tmesh.make_mesh(4, device="cpu")
    assert m.owners == (0, 0, 1, 1) and m.local_slots == (2, 3) and m.world == 2 and m.rank == 1
    assert [d.type for d in m.devices] == ["meta", "meta", "cpu", "cpu"]
    assert m.distinct_devices == (torch.device("cpu"),)
    assert m.describe() == "4 shards over 2 ranks x 2 slots on cpu (gloo)"
    with pytest.raises(ValueError, match="3 slots do not split evenly over 2 ranks"):
        tmesh.make_mesh(3, device="cpu")
    grid = distributed.make_multihost_mesh(2, device="cpu")
    assert grid.shape == (2, 2) and grid.owners == (0, 0, 1, 1)


@pytest.mark.parametrize("visible,count,want", [(None, 4, ["0", "1", "2", "3", "0"]), (None, 1, ["0"] * 5),
                                                ("5,7", 2, ["5", "7", "5", "7", "5"])])
def test_each_fleet_backend_sees_a_card_of_its_own(tmp_path, monkeypatch, visible, count, want):
    """Backend i's CUDA_VISIBLE_DEVICES is the parent's visible card i % count
    (the card count faked); on the CPU none is set, and the child's --device
    is the fleet's."""
    launched = []

    class FakePopen:
        def __init__(self, cmd, env=None, **_kw):
            launched.append((cmd, env))

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    if visible is None:
        monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    else:
        monkeypatch.setenv("CUDA_VISIBLE_DEVICES", visible)
    monkeypatch.setattr("cuda_mpi_gpu_cluster_programming_tpu_torch.serving.fleet.subprocess.Popen", FakePopen)
    fleet = BackendFleet(5, tmp_path, device="cuda")
    for i in range(5):
        fleet._launch(i)
    assert [env["CUDA_VISIBLE_DEVICES"] for _, env in launched] == want
    assert all(cmd[cmd.index("--device") + 1] == "cuda" for cmd, _ in launched)
    launched.clear()
    BackendFleet(2, tmp_path, device="cpu")._launch(1)
    assert launched[0][1].get("CUDA_VISIBLE_DEVICES") == (visible if visible is not None else None)
