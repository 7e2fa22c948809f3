"""The port's mesh layer (parallel/mesh.py, parallel/collectives.py,
config.py::parse_mesh_shape, data/pipeline.py's per-host and per-rank
slices, parallel/dryrun.py) against JAX's, on the CPU.

The port's ranks run in fresh interpreters over gloo
(``parallel/dryrun.py::start_ranks``, ``tests/torch_mesh_ranks.py``), once
for the module; JAX runs on ``tests/conftest.py``'s virtual devices through
a ``Mesh`` of ``jax.devices()[:4]``.

- Placements: the dry run's model with a 63-wide text FFN, parameter by
  parameter, against JAX's ``param_shardings`` on the same Flax path (the
  spec reversed where the port's weight is the transposed Dense kernel), on
  a dp mesh and a dp=2,tp=2 mesh; exactly equal.
- ``mean_over_mesh`` within 1e-5 of JAX's (7 values, padded to the mesh).
- ``parse_mesh_shape`` and ``shard_for_host``: equal to JAX's, errors
  included.
- ``dryrun_multichip(4)`` with ``MMRP_DRYRUN_SECTIONS=boot``.
"""

import functools
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from mmrp_tpu.config import Config as JConfig
from mmrp_tpu.data.pipeline import shard_for_host as jshard_for_host
from mmrp_tpu.models import multimodal as jmm
from mmrp_tpu.models.swin import SwinConfig as JSwinConfig
from mmrp_tpu.models.text_encoder import TextConfig as JTextConfig
from mmrp_tpu.parallel import collectives as jcoll
from mmrp_tpu.parallel import mesh as jmesh
from mmrp_tpu_torch.config import Config
from mmrp_tpu_torch.data.pipeline import device_put_sharded_batch, shard_for_host
from mmrp_tpu_torch.models.multimodal import MultiModalRetrievalModel
from mmrp_tpu_torch.parallel.collectives import initialize_distributed
from mmrp_tpu_torch.parallel.dryrun import dryrun_multichip, start_ranks
from mmrp_tpu_torch.utils.convert import flax_paths
from torch_mesh_ranks import micro_mm_config

TESTS = str(Path(__file__).resolve().parent)
VALUES = np.random.default_rng(0).standard_normal(7).astype(np.float32)


@pytest.fixture(scope="module")
def ranks():
    """Every rank's results."""
    return start_ranks(4, "torch_mesh_ranks:mesh_checks", {"values": VALUES.tolist()},
                       sys_path=[TESTS], timeout_s=240, threads=1).wait()


@functools.lru_cache(maxsize=None)
def jax_params():
    """The dry run's model with a 63-wide text FFN, as Flax shapes (traced
    once for the module)."""
    jcfg = jmm.MultiModalConfig(
        swin=JSwinConfig(img_size=56, embed_dim=16, depths=(2, 1), num_heads=(2, 2),
                         window_size=7, use_pallas=False),
        text=JTextConfig.small(vocab_size=512, hidden_dim=32, num_layers=2, num_heads=2,
                               intermediate_dim=63, max_positions=64),
        joint_dim=32, num_fusion_layers=2, num_heads=4, num_classes=43, max_text_len=16)
    model = jmm.MultiModalRetrievalModel(jcfg)
    img = np.zeros((1, 56, 56, 3), np.float32)
    ids = np.zeros((1, 16), np.int32)
    return jax.eval_shape(model.init, jax.random.PRNGKey(0), img, ids, ids)["params"]


def jax_specs(mesh):
    flat = jax.tree_util.tree_flatten_with_path(jmesh.param_shardings(jax_params(), mesh))[0]
    return {"/".join(str(p.key) for p in path): s.spec for path, s in flat}


def expected(spec, transposed, names):
    """A JAX spec (Flax layout) as the port's placement strings per mesh dim."""
    dims = list(spec) + [None] * (2 - len(spec))
    if transposed:
        dims = dims[::-1]
    out = ["R"] * len(names)
    for d, ax in enumerate(dims):
        if ax is not None:
            out[names.index(ax)] = f"S{d}"
    return out


@pytest.mark.parametrize("label,names,sizes", [("dp", ("dp",), (4,)),
                                               ("dp_tp", ("dp", "tp"), (2, 2))])
def test_param_shardings_match_jax(ranks, label, names, sizes):
    mesh = jmesh.build_mesh(names, sizes, jax.devices()[:4])
    specs = jax_specs(mesh)
    paths = flax_paths(MultiModalRetrievalModel(micro_mm_config(intermediate_dim=63),
                                                device="meta"))
    got = ranks[0]["placements"][label]
    assert set(got) == set(paths)
    sharded = 0
    for name, (path, transposed) in paths.items():
        want = expected(specs[path], transposed, list(names))
        assert got[name] == want, (name, path, specs[path])
        sharded += want != ["R"] * len(names)
    # the dp=2,tp=2 mesh shards the 6 Dense kernels the rules name, except the
    # text FFN (63 does not split in two); a dp mesh shards nothing
    assert sharded == (0 if label == "dp" else 6)
    assert all(r["shapes"][label] == str(mesh.shape) for r in ranks)


def test_placed_master_is_a_block_and_gathers_whole(ranks):
    # cls_hidden (32 -> 128): Flax P(None, "tp") -> Shard(0) of the (128, 32) weight
    assert ranks[0]["block_shape"] == [64, 32]
    assert all(r["whole_equal"] for r in ranks)


def test_mean_over_mesh_and_metric_psum_match_jax(ranks):
    for label, names, sizes in (("dp", ("dp",), (4,)), ("dp_tp", ("dp", "tp"), (2, 2))):
        mesh = jmesh.build_mesh(names, sizes, jax.devices()[:4])
        want = jcoll.mean_over_mesh(mesh, VALUES)
        for r in ranks:
            np.testing.assert_allclose(r["mean"][label], want, rtol=1e-5, atol=1e-6)
    # per-rank blocks arange(4) + rank summed over the dp line
    assert ranks[0]["psum"]["dp"] == [float(sum(range(4)) * 4 + 4 * 6), 16.0]
    assert ranks[0]["psum"]["dp_tp"] == [float(sum(range(4)) * 2 + 4 * (0 + 2)), 8.0]


def test_build_mesh_errors_as_jax(ranks):
    with pytest.raises(ValueError) as jerr:
        jmesh.build_mesh(("dp",), (3,), jax.devices()[:4])
    assert ranks[0]["error"] == str(jerr.value) == "mesh (3,) != 4 devices"


@pytest.mark.parametrize("shape,n", [("auto", 8), ("dp=8", 8), ("dp=4,tp=2", 8),
                                     ("dp=2, tp=2", 4), ("dp=4,tp=2", 4)])
def test_parse_mesh_shape_matches_jax(shape, n):
    port, jcfg = Config(mesh_shape=shape), JConfig(mesh_shape=shape)
    try:
        want = jcfg.parse_mesh_shape(n)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).replace("(", r"\(").replace(")", r"\)")):
            port.parse_mesh_shape(n)
        return
    assert port.parse_mesh_shape(n) == want


def test_mesh_shape_round_trips_the_flat_yaml(tmp_path):
    from mmrp_tpu_torch.config import dump_flat_yaml

    path = tmp_path / "c.yaml"
    dump_flat_yaml(Config(mesh_shape="dp=4,tp=2").to_dict(), str(path))
    for cfg in (Config.load(str(path)), JConfig.load(str(path))):
        assert cfg.mesh_shape == "dp=4,tp=2"
        assert cfg.parse_mesh_shape(8) == (("dp", "tp"), (4, 2))


@pytest.mark.parametrize("hosts", [1, 3, 4])
def test_shard_for_host_matches_jax(hosts):
    records = [{"id": i} for i in range(10)]
    for h in range(hosts):
        assert shard_for_host(records, h, hosts) == jshard_for_host(records, h, hosts)


def test_device_put_sharded_batch_takes_this_ranks_rows():
    class OneAxis:  # a DeviceMesh's attributes that the slice reads: rank 1 of 2
        device_type = "cpu"
        mesh_dim_names = ("dp",)
        mesh = torch.zeros(2)

        def get_local_rank(self, axis):
            return 1

    batch = {"image": np.arange(8.0).reshape(4, 2), "ids": ["a", "b", "c", "d"],
             "n": np.float32(3)}
    out = device_put_sharded_batch(batch, OneAxis())
    assert torch.equal(out["image"], torch.tensor([[4.0, 5.0], [6.0, 7.0]], dtype=torch.float64))
    assert out["ids"] == batch["ids"] and out["n"] == batch["n"]
    with pytest.raises(ValueError, match="do not shard"):
        device_put_sharded_batch({"x": np.zeros(3)}, OneAxis())


def test_initialize_distributed_without_a_coordinator_or_a_card(monkeypatch):
    for var in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    assert initialize_distributed() is False
    with pytest.raises(RuntimeError, match="NCCL needs a CUDA device"):
        initialize_distributed("localhost:1", 1, 0)  # the default backend is NCCL
    with pytest.raises(ValueError, match="gloo"):
        initialize_distributed("localhost:1", 1, 0, cpu_collectives="mpi")


def test_dryrun_multichip_boot(monkeypatch, capsys):
    monkeypatch.setenv("MMRP_DRYRUN_SECTIONS", "boot")
    res = dryrun_multichip(4, timeout_s=240)
    assert res["mesh"] == {"dp": 2, "tp": 2} and res["top1"] != "g3"
    assert np.isfinite(res["loss"])
    assert capsys.readouterr().out.strip().endswith("sections=boot OK")
