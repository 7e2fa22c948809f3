"""The port's data-parallel train step (train/joint.py::make_train_step_dp)
on a 2-rank mesh against JAX's on a 2-device mesh and against the port's
own ``make_train_step`` on the whole batch, on the CPU.

``tests/test_train_dp.py``'s micro config (batch 16, 28 px, one Swin
stage, one text layer, one fusion layer, dropout 0), with and without
``kg_dim``, from JAX's ``init_train_state`` (weights and ``kg_proj``
carried over through an npz); the core route off (``core_kernel=False``),
as JAX's exact test. The two gloo ranks run once for the module
(``tests/torch_mesh_ranks.py::train_dp_checks``, fresh interpreters).

Two steps on each side: the first update's rate is 0 (warmup), so the
masters after step 1 are the initial ones and only the metrics (the loss
and the gradient norm) test the gradients; the second update's rate is
lr / 5, so the masters after step 2 hold the all-reduced gradients
element by element. Tolerances:
- against JAX's dp step: metrics rtol 2e-4 and masters atol 2e-4, the
  port-vs-JAX bounds of ``test_torch_train.py`` (f32 through every layer,
  Flax's one-pass LayerNorm variance against two passes); and after the
  second update, as there, at most 0.1% of the masters more than 1% of the
  update's rate from JAX's (Adam's update is about the rate times the sign
  of a gradient, so a gradient near 0 may flip);
- against the port's own plain step: metrics atol 1e-5 and masters atol
  1e-6 after step 1, JAX's own contract between its dp and plain steps
  (the gathered loss is the same function; only the ranks' sums of
  gradients differ in order), and the gradients that each update takes
  (all-reduced and divided by the ranks) atol 1e-6; after step 2 the
  masters within 1e-6 but for at most 0.1% of them (a gradient that is
  rounding noise, as the key biases' is, takes an update of about the rate
  either way), and all within twice the rate.
A third dp step must move the masters and keep the loss finite.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import __graft_entry__ as G
from mmrp_tpu.config import Config
from mmrp_tpu.models.multimodal import MultiModalConfig, MultiModalRetrievalModel
from mmrp_tpu.models.swin import SwinConfig
from mmrp_tpu.models.text_encoder import TextConfig
from mmrp_tpu.train.joint import init_train_state, make_train_step_dp
from mmrp_tpu_torch.parallel.dryrun import start_ranks
from mmrp_tpu_torch.utils.convert import flax_to_state_dict

TESTS = str(Path(__file__).resolve().parent)
B, IMG, LTXT, VOCAB, KG_DIM = 16, 28, 8, 64, 12
TAGS = {"nokg": None, "kg": KG_DIM}


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(flat(v, key) if isinstance(v, dict) else {key: np.asarray(v)})
    return out


class JitInit:
    """The model as ``init_train_state`` reads it, with ``init`` jitted (an
    eager Flax init of this model takes about 25 s on the CPU)."""

    def __init__(self, model):
        self.config, self.apply = model.config, model.apply
        self.init = jax.jit(model.init, static_argnames=("deterministic",))


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """{tag: (JAX metrics, JAX masters by port name, the ranks' results,
    the port's masters after the dp and the plain step)}."""
    root = tmp_path_factory.mktemp("train_dp")
    swin = SwinConfig(img_size=IMG, embed_dim=16, depths=(1,), num_heads=(2,), window_size=7,
                      use_pallas=False, drop_path_rate=0.0)
    text = TextConfig.small(vocab_size=VOCAB, hidden_dim=16, num_layers=1, num_heads=2,
                            intermediate_dim=32, max_positions=16, dropout=0.0)
    model = MultiModalRetrievalModel(MultiModalConfig(
        swin=swin, text=text, joint_dim=16, num_fusion_layers=1, num_heads=2, num_classes=43,
        max_text_len=LTXT, dropout=0.0, drop_path=0.0))
    cfg = Config(lr=1e-3, batch_size=B, adam_mu_bf16=True)
    mesh = Mesh(np.array(jax.devices()[:2]), ("dp",))
    jit_init = JitInit(model)
    states = {}
    for tag, kg_dim in TAGS.items():
        batch_np = G._example_batch(B=B, img=IMG, L=LTXT, vocab=VOCAB, seed=3, kg_dim=kg_dim)
        batch = {k: jnp.asarray(v) for k, v in batch_np.items()}
        states[tag] = (init_train_state(jit_init, cfg, jax.random.PRNGKey(0), batch,
                                        total_steps=50, kg_dim=kg_dim), batch)
        np.savez(root / f"params_{tag}.npz", **flat(jax.device_get(states[tag][0].params)))
        np.savez(root / f"batch_{tag}.npz", **batch_np)
    # the ranks run beside JAX's steps
    ranks = start_ranks(2, "torch_mesh_ranks:train_dp_checks", {"out": str(root)},
                        sys_path=[TESTS], timeout_s=300, threads=1)
    jax_out = {}
    for tag, (state, batch) in states.items():
        sharded = {k: jax.device_put(v, NamedSharding(mesh, P("dp"))) for k, v in batch.items()}
        step = make_train_step_dp(model, cfg, mesh, donate=False, core_kernel=False)
        metrics, params = {}, {}
        for i in (1, 2):
            state, m_dp = step(state, sharded)
            metrics[i] = {k: float(v) for k, v in m_dp.items()}
            params[i] = {k: v.numpy() for k, v in flax_to_state_dict(
                jax.device_get(state.params)).items()}
        jax_out[tag] = (metrics, params)
    res = ranks.wait()
    out = {}
    for tag in TAGS:
        with np.load(root / f"out_{tag}.npz") as z:
            port = {k: z[k] for k in z.files}
        out[tag] = (*jax_out[tag], res, port)
    out["root"] = str(root)
    return out


@pytest.mark.parametrize("tag", list(TAGS))
def test_dp_step_matches_jax_dp_step(steps, tag):
    jm, jparams, res, port = steps[tag]
    rate = 1e-3 / 5  # the second update's: warmup of max(1, 50 // 10) steps
    for i in (1, 2):
        for r in res:  # every rank: the same global metrics
            assert set(r[tag][f"dp{i}"]) == set(jm[i])
            for key in jm[i]:
                np.testing.assert_allclose(r[tag][f"dp{i}"][key], jm[i][key], rtol=2e-4,
                                           err_msg=f"step {i} {key}")
        assert ("loss/kg_align" in jm[i]) == (tag == "kg")
        names = {k.split("/", 1)[1] for k in port if k.startswith(f"dp{i}/")}
        assert names == set(jparams[i])
        moved = 0
        for name, want in jparams[i].items():
            got = port[f"dp{i}/{name}"]
            np.testing.assert_allclose(got, want, rtol=0, atol=2e-4, err_msg=f"step {i} {name}")
            moved += int((np.abs(got - want) > 1e-2 * rate).sum())
        assert moved <= sum(v.size for v in jparams[i].values()) // 1000, (i, moved)
    # the second update moved the masters by about its rate
    assert max(float(np.abs(jparams[2][k] - jparams[1][k]).max()) for k in jparams[1]) > rate / 2


@pytest.mark.parametrize("tag", list(TAGS))
def test_dp_step_matches_the_plain_step(steps, tag):
    _, _, res, port = steps[tag]
    rate = 1e-3 / 5
    for i in (1, 2):
        for r in res:
            for key, want in r[tag][f"plain{i}"].items():
                np.testing.assert_allclose(r[tag][f"dp{i}"][key], want, rtol=0, atol=1e-5,
                                           err_msg=f"step {i} {key}")
        grads = [k for k in port if k.startswith(f"grad_dp{i}/")]
        assert len(grads) == len([k for k in port if k.startswith(f"dp{i}/")])
        for key in grads:
            np.testing.assert_allclose(port[key], port[key.replace("grad_dp", "grad_plain")],
                                       rtol=0, atol=1e-6, err_msg=key)
        far, total = 0, 0
        for key in (k for k in port if k.startswith(f"dp{i}/")):
            got, want = port[key], port[f"plain{i}/" + key.split("/", 1)[1]]
            if i == 1:
                np.testing.assert_allclose(got, want, rtol=0, atol=1e-6, err_msg=key)
            np.testing.assert_array_less(np.abs(got - want), 2 * rate, err_msg=key)
            far += int((np.abs(got - want) > 1e-6).sum())
            total += got.size
        assert far <= total // 1000, (i, far, total)


@pytest.mark.parametrize("tag", list(TAGS))
def test_dp_steps_train(steps, tag):
    res = steps[tag][2]
    for r in res:
        assert r[f"{tag}_moved"] > 0 and np.isfinite(r[f"{tag}_loss3"])
    assert res[0][f"{tag}_loss3"] == res[1][f"{tag}_loss3"]  # the same state on both ranks


def test_joint_training_on_a_mesh_is_the_run_without_one(steps):
    """``run_joint_training`` on a dp=1, tp=2 mesh (the TP rules' masters
    and moments as DTensor blocks, gathered whole into the model after each
    step and into each checkpoint) equals the run without a mesh bit for bit,
    and so does a mesh run killed after epoch 0 and resumed under the mesh;
    rank 0 alone writes the files, the same files as the run without a
    mesh."""
    res = steps["nokg"][2]
    root = Path(steps["root"])
    with np.load(root / "pipeline.npz") as z:
        got = {k: z[k] for k in z.files}
    single = {k.split("/", 1)[1]: v for k, v in got.items() if k.startswith("single/")}
    assert "cls_hidden.weight" in single
    for label in ("mesh", "resumed"):
        for k, v in single.items():
            np.testing.assert_array_equal(got[f"{label}/{k}"], v, err_msg=f"{label} {k}")
    files = res[0]["pipeline"]["files"]
    assert files["mesh"] == files["single"] and "ckpt/steps/1/state.pt" in files["mesh"]
    assert res[1]["pipeline"]["files"]["mesh"] == files["mesh"]  # one directory, rank 0's
