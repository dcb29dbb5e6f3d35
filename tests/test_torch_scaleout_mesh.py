"""The port's mesh and process group (parallel/mesh.py,
parallel/distributed.py) and its dry-run hooks (parallel/dryrun.py) on the
CPU: ``make_mesh``'s shape, axis names and ValueError as
tests/test_parallel.py holds the JAX one's, each rank's place and groups,
the TP plan's slices, ``entry``, ``dryrun_multichip(4)`` (a 2 x 2 mesh: one
sharded step, mesh serving equal to meshless serving) and
``dryrun_multiprocess(2, 1)`` (the same on two ranks, then the worker in
two OS processes); and the new modules import no jax."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from audio_analysis_torch.parallel import distributed as tdist
from audio_analysis_torch.parallel import dryrun
from audio_analysis_torch.parallel.mesh import make_mesh

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh_rank():
    """One rank of an eight-rank world: its mesh, place, groups and TP
    slices."""
    import torch.distributed as dist

    from audio_analysis_torch.models.birdnet import TuiNet, TuiNetConfig
    from audio_analysis_torch.parallel import mesh as m
    from audio_analysis_torch.parallel.train import shard_params

    mesh = make_mesh(n_devices=8, model_parallel=2, device_type="cpu")
    cfg = TuiNetConfig(num_classes=4, n_mels=32, channels=(8,), dense_units=64)
    net = shard_params(TuiNet.init(cfg, torch.Generator().manual_seed(0)), mesh)
    full = TuiNet.init(cfg, torch.Generator().manual_seed(0))
    k = m.model_index(mesh)
    return {
        "shape": tuple(mesh.shape), "names": mesh.mesh_dim_names,
        "data": m.data_index(mesh), "model": k, "device": str(m.rank_device(mesh)),
        "data_ranks": dist.get_process_group_ranks(m.data_group(mesh)),
        "model_ranks": dist.get_process_group_ranks(m.model_group(mesh)),
        "shapes": {n: tuple(p.shape) for n, p in net.named_parameters()},
        "slices": bool(torch.equal(net.head_w1, full.head_w1[:, 32 * k : 32 * (k + 1)])
                       and torch.equal(net.head_w2, full.head_w2[32 * k : 32 * (k + 1)])
                       and torch.equal(net.stem_w, full.stem_w)),
        "world_of_8": tdist.allgather_host_values(dist.get_rank()),
    }


def test_mesh_axes_places_and_tp_plan():
    """Eight ranks: a (4, 2) ('data', 'model') mesh; rank r at data r // 2,
    model r % 2; its data group the ranks of its model index, its model
    group the ranks of its data index; the head split along 'model'
    (w1 by output column, b1 with it, w2 by input row), everything else
    whole (tests/test_parallel.py's test_mesh_axes and TP plan)."""
    out = tdist.spawn(_mesh_rank, 8, device="cpu", deadline=300)
    for r, got in enumerate(out):
        assert got["shape"] == (4, 2) and got["names"] == ("data", "model")
        assert (got["data"], got["model"]) == (r // 2, r % 2)
        assert got["data_ranks"] == [r % 2 + 2 * i for i in range(4)]
        assert got["model_ranks"] == [2 * (r // 2), 2 * (r // 2) + 1]
        assert got["device"] == "cpu" and got["slices"]
        assert got["shapes"]["head_w1"] == (8, 32) and got["shapes"]["head_b1"] == (32,)
        assert got["shapes"]["head_w2"] == (32, 4) and got["shapes"]["head_b2"] == (4,)
        assert got["shapes"]["stem_w"] == (32, 1, 3, 3)
        assert got["world_of_8"] == list(range(8))


def test_mesh_needs_a_group_and_a_divisible_world():
    with pytest.raises(RuntimeError, match="initialize"):
        make_mesh(device_type="cpu")
    tdist.initialize(device="cpu")
    try:
        with pytest.raises(ValueError, match="1 devices not divisible by model_parallel=2"):
            make_mesh(model_parallel=2, device_type="cpu")
        with pytest.raises(ValueError, match="needs a world of 8 ranks"):
            make_mesh(n_devices=8, device_type="cpu")
        mesh = make_mesh(device_type="cpu")
        assert tuple(mesh.shape) == (1, 1) and mesh.mesh_dim_names == ("data", "model")
        assert tdist.allgather_results([{"a": 1}]) == [{"a": 1}]
        assert not tdist.is_multihost()
    finally:
        tdist.shutdown()
    with pytest.raises(ValueError, match="coordinator_address"):
        tdist.initialize(num_processes=2, process_id=0, device="cpu")


def test_entry_hook():
    fn, args = dryrun.entry(device="cpu")
    out = fn(*args)
    assert out.shape == (4, 8) and torch.isfinite(out).all()
    np.testing.assert_allclose(out.sum(dim=-1).numpy(), 1.0, rtol=1e-5)


def test_dryrun_multichip_hook():
    """Four CPU ranks, a 2 x 2 mesh: one sharded training step, and mesh
    serving equal to the meshless analyzer (TuiNet alone, and with an
    embeddings pre-model group) bit for bit on every rank."""
    out = dryrun.dryrun_multichip(4, device_type="cpu")
    assert [o["mesh"] for o in out] == [(2, 2)] * 4
    assert all(o["served"] == 4 and np.isfinite(o["loss"]) for o in out)
    assert len({o["loss"] for o in out}) == 1


def test_dryrun_multiprocess_hook():
    """Two ranks (a 1 x 2 mesh: the step with the head split, serving equal
    to meshless), then the worker module in two OS processes joined through
    a file: each writes the whole global list."""
    summaries, out = dryrun.dryrun_multiprocess(2, 1, device_type="cpu")
    assert [s["mesh"] for s in summaries] == [(1, 2)] * 2
    assert all(s["served"] == 2 and np.isfinite(s["loss"]) for s in summaries)
    assert len(out) == 2 and all("species_identify" in r for r in out)


def test_new_modules_import_no_jax():
    """The scale-out modules and their callers, in a fresh interpreter:
    neither jax nor the JAX package (nor h5py or tensorflow) is loaded."""
    code = (
        "import importlib, sys\n"
        "for m in ('audio_analysis_torch.parallel.mesh', 'audio_analysis_torch.parallel.distributed',\n"
        "          'audio_analysis_torch.parallel.worker', 'audio_analysis_torch.parallel.dryrun',\n"
        "          'audio_analysis_torch.parallel.train', 'audio_analysis_torch.parallel.finetune',\n"
        "          'audio_analysis_torch.pipeline.serve', 'audio_analysis_torch.cli.train',\n"
        "          'audio_analysis_torch.cli.finetune'):\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'audio_analysis_tpu', 'h5py', 'tensorflow', 'optax'))\n"
        "sys.exit(1 if bad else 0)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
