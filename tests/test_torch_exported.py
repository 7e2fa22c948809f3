"""The port's serialized serving artifact (serve/exported.py) against the live
port and JAX's artifact, on the CPU.

The micro model of ``tests/test_exported.py`` (``SwinConfig.micro``,
``TextConfig.small``, 28 px, 12 tokens) with the same randomized weights in
both packages: export -> save -> load -> call at n = 1, 3, 4 and 9 with
buckets (1, 4) (an exact bucket, a padded one, a chunked oversize request)
against the port's live ``serving_forward`` on the same rows (1e-6: the
program runs the plain versions' aten ops; a request the live path runs at
another batch size differs by GEMM blocking only) and against JAX's
``ExportedPredictor`` (JAX's own 2e-4); loading in a fresh process with no
model module imported; the error paths; each tensor of the state stored once;
and each kernel op's fake implementation against its plain version's output
(shape, dtype and strides) under ``FakeTensorMode`` with fake CUDA tensors.
"""

import io
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from mmrp_tpu.models import multimodal as jmm
from mmrp_tpu.models.swin import SwinConfig as JSwinConfig
from mmrp_tpu.models.text_encoder import TextConfig as JTextConfig
from mmrp_tpu.serve import exported as jexported
from mmrp_tpu_torch.api import serving_forward
from mmrp_tpu_torch.models.multimodal import MultiModalConfig, MultiModalRetrievalModel
from mmrp_tpu_torch.models.swin import SwinConfig
from mmrp_tpu_torch.models.text_encoder import TextConfig
from mmrp_tpu_torch.ops import fused_attention as K3
from mmrp_tpu_torch.ops import fused_mlp as K2
from mmrp_tpu_torch.ops import fused_swin_block as SB
from mmrp_tpu_torch.ops import fused_swin_pair as SP
from mmrp_tpu_torch.ops import fused_window_attention as K1
from mmrp_tpu_torch.serve import exported
from mmrp_tpu_torch.utils.convert import load_flax_params
from test_torch_slice import randomize

IMG, LT = 28, 12
HEAD = dict(joint_dim=32, num_fusion_layers=1, num_heads=2, num_classes=7, max_text_len=LT)
BUCKETS = (1, 4)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def inputs(n, seed):
    rng = np.random.default_rng(seed)
    img = rng.random((n, IMG, IMG, 3)).astype(np.float32)
    ids = rng.integers(0, 8192, (n, LT)).astype(np.int32)
    mask = (np.arange(LT)[None, :] < rng.integers(4, LT + 1, (n, 1))).astype(np.int32)
    return img, ids, mask


@pytest.fixture(scope="module")
def micro(tmp_path_factory):
    """(JAX model, params, port model, port artifact path, JAX artifact path)."""
    jcfg = jmm.MultiModalConfig(swin=JSwinConfig.micro(), text=JTextConfig.small(), **HEAD)
    jmodel = jmm.MultiModalRetrievalModel(jcfg)
    img, ids, mask = inputs(1, 0)
    params = randomize(jax.jit(jmodel.init)(jax.random.PRNGKey(0), img, ids, mask)["params"])
    model = MultiModalRetrievalModel(MultiModalConfig(
        swin=SwinConfig.micro(), text=TextConfig.small(), **HEAD), device="cpu").eval()
    load_flax_params(model, params)
    root = tmp_path_factory.mktemp("artifacts")
    meta = {"image_size": IMG, "text_len": LT, "batch_sizes": list(BUCKETS)}
    programs = exported.export_serving_programs(model, image_size=IMG, text_len=LT,
                                                batch_sizes=BUCKETS, platforms=("cpu",))
    assert set(programs) == {"cpu::1", "cpu::4"}
    exported.save_artifact(root / "port.npz", programs, exported.serving_state(model), meta)
    jprograms = jexported.export_serving_programs(jmodel, params, image_size=IMG, text_len=LT,
                                                  batch_sizes=BUCKETS, platforms=("cpu",))
    jexported.save_artifact(root / "jax.npz", jprograms, params, meta)
    return jmodel, params, model, root / "port.npz", root / "jax.npz"


def test_artifact_matches_the_live_port_and_jax(micro):
    """n = 1, 3, 4, 9: the loaded cpu programs against the live
    ``serving_forward`` (1e-6) and JAX's loaded artifact (rtol 2e-4, atol 2e-5
    on probs and 2e-4 on the embeddings, JAX's own test's bounds)."""
    _, _, model, path, jpath = micro
    pred = exported.ExportedPredictor.load(path, platform="cpu")
    jpred = jexported.ExportedPredictor.load(jpath, platform="cpu")
    assert pred.batch_sizes == list(BUCKETS) and pred.meta["image_size"] == IMG
    live = serving_forward(model)
    for n in (1, 3, 4, 9):
        img, ids, mask = inputs(n, seed=n)
        got = pred.call(img, ids, mask)
        want = {k: v.numpy() for k, v in live(torch.from_numpy(img), torch.from_numpy(ids).long(),
                                              torch.from_numpy(mask).long()).items()}
        jwant = jpred.call(img, ids, mask)
        assert set(got) == set(want) == set(exported.OUTPUTS)
        for key in got:
            assert got[key].shape[0] == n, key
            np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-6, err_msg=key)
            tol = dict(rtol=2e-4, atol=2e-5) if key == "probs" else dict(rtol=2e-4, atol=2e-4)
            np.testing.assert_allclose(got[key], jwant[key], err_msg=key, **tol)


LOAD_ALONE = """
import sys
import numpy as np
from mmrp_tpu_torch.serve.exported import ExportedPredictor
pred = ExportedPredictor.load(sys.argv[1], platform="cpu")
rng = np.random.default_rng(0)
out = pred.call(rng.random((3, 28, 28, 3), dtype=np.float32), rng.integers(0, 8192, (3, 12)),
                np.ones((3, 12), np.int64))
assert out["probs"].shape == (3, 7), out["probs"].shape
bad = [m for m in sys.modules if m.startswith(("mmrp_tpu_torch.models", "mmrp_tpu_torch.train",
                                               "mmrp_tpu_torch.serve.runner", "jax", "mmrp_tpu."))]
assert not bad, bad
print("ok")
"""


def test_load_and_call_need_no_model_code(micro):
    """In a fresh process: load + call import the op registrations and no
    module of ``mmrp_tpu_torch.models``, ``train`` or ``serve.runner`` (nor
    JAX)."""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", LOAD_ALONE, str(micro[3])], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr[-3000:]


def test_error_paths(micro, tmp_path):
    """tpu, cuda without a card (export and load), a mesh (ROADMAP item
    10c), and a platform the artifact lacks, which names the available ones
    as JAX's does."""
    model, path = micro[2], micro[3]
    kw = dict(image_size=IMG, text_len=LT, batch_sizes=(1,))
    with pytest.raises(ValueError, match="tpu"):
        exported.export_serving_programs(model, platforms=("tpu",), **kw)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        exported.export_serving_programs(model, platforms=("cuda",), **kw)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        exported.ExportedPredictor.load(path)  # the default platform is cuda
    with pytest.raises(NotImplementedError, match="Queue 1 item 10c"):
        exported.export_serving_programs(model, platforms=("cpu",), mesh=object(), **kw)
    with pytest.raises(NotImplementedError, match="Queue 1 item 10c"):
        exported.ExportedPredictor.load(path, platform="cpu", mesh=object())
    with pytest.raises(ValueError, match="tpu"):
        exported.ExportedPredictor.load(path, platform="tpu")
    cuda_only = tmp_path / "cuda_only.npz"
    exported.save_artifact(cuda_only, {"cuda::1": b"\0"}, {}, {})
    with pytest.raises(ValueError, match=r"no programs for platform 'cpu' \(available: "
                                         r"\['cuda'\]\); re-export with --platforms cpu"):
        exported.ExportedPredictor.load(cuda_only, platform="cpu")


def test_each_tensor_of_the_state_is_stored_once(micro):
    """One ``p::`` array per parameter and buffer, the programs hold none
    (no state dict, no constants, no example inputs), and the file is no
    larger than the state, the programs and 64 KB of zip headers."""
    model, path = micro[2], micro[3]
    state = exported.serving_state(model)
    with np.load(path) as z:
        keys = [k for k in z.files if k.startswith("p::")]
        blobs = {k: z[k].tobytes() for k in z.files if k.startswith("prog::")}
    assert sorted(keys) == sorted(f"p::{k}" for k in state)
    for blob in blobs.values():
        ep = torch.export.load(io.BytesIO(blob))
        assert not ep.state_dict and not ep.constants and ep.example_inputs is None
    state_bytes = sum(t.numel() * t.element_size() for t in state.values())
    assert os.path.getsize(path) <= state_bytes + sum(map(len, blobs.values())) + 65536


# -- the kernels' ops: fake implementations ----------------------------------------


def _bf16(rng, *shape, scale=1.0):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * scale).bfloat16()


def _f32(rng, *shape, scale=1.0, base=0.0):
    return torch.from_numpy(base + rng.standard_normal(shape).astype(np.float32) * scale)


def _blk(rng, C, Hd):
    return [_f32(rng, C, base=1.0, scale=0.1), _f32(rng, C, scale=0.1),
            _bf16(rng, 3 * C, C, scale=C ** -0.5), _bf16(rng, 3 * C, scale=0.1),
            _bf16(rng, C, C, scale=C ** -0.5), _bf16(rng, C, scale=0.1),
            _f32(rng, C, base=1.0, scale=0.1), _f32(rng, C, scale=0.1),
            _bf16(rng, Hd, C, scale=C ** -0.5), _bf16(rng, Hd, scale=0.1),
            _bf16(rng, C, Hd, scale=Hd ** -0.5), _bf16(rng, C, scale=0.1)]


def _case(name, rng):
    """(the op, its arguments, the plain version's output on them): micro
    shapes, C 32, 2 heads, 7 x 7 windows on a 14 x 14 map."""
    C, h, ws, Hd = 32, 2, 7, 128
    bias = _f32(rng, 4, h, ws * ws, ws * ws)
    if name == "window_attention":
        xw = _bf16(rng, 2, 4, ws * ws, C)
        a = [xw, *_blk(rng, C, Hd)[:6], bias, h, 1e-6, True]
        return a, K1.window_attention_plain(*a)
    if name == "ln_mlp":
        blk = _blk(rng, C, Hd)
        a = [_bf16(rng, 50, C), *blk[6:8], *blk[8:], 1e-6, False, True]
        return a, K2.ln_mlp_plain(*a)
    if name == "seq_attention":
        x, blk = _bf16(rng, 2, 9, C), _blk(rng, C, Hd)
        w = [blk[4], blk[5]] * 4
        a = [x, blk[0], blk[1], *w, None, _f32(rng, 2, 9), None, None, [],
             dict(num_heads=h, ln_mode="post", include_residual=True, residual_from_raw=False,
                  eps=1e-6, quant=False)]
        return a, K3.attention_plain(*a[:15], **{k: v for k, v in a[-1].items() if k != "quant"})
    x = _bf16(rng, 2, 14, 14, C)
    blk = _blk(rng, C, Hd)
    if name == "swin_block_windows":
        xw = _bf16(rng, 2, 4, ws * ws, C)
        return [xw, blk, bias, [], h, 1e-6, 0, None], SB.swin_block_plain(xw, *blk, bias, h)
    if name == "swin_block_raw":
        return [x, blk, bias, [], h, ws, 1e-6, 0], SB.raw_plain(x, *blk, bias, num_heads=h, ws=ws)
    if name == "swin_block_chain":
        return ([x, blk, bias, [], h, ws, 3, 1e-6, 0, None],
                SP.chain_plain(x, blk, bias, h, ws, 3))
    blk1 = _blk(rng, C, Hd)
    return ([x, blk, bias, blk1, bias, [], [], h, ws, 3, 1e-6, 0, None, None],
            SP.pair_plain(x, blk, bias, blk1, bias, h, ws, 3))


OPS = ("window_attention", "ln_mlp", "seq_attention", "swin_block_windows", "swin_block_raw",
       "swin_block_chain", "swin_block_pair")


@pytest.mark.parametrize("name", OPS)
def test_op_fake_is_the_plain_output(name):
    """``torch.ops.mmrp.<name>`` on fake CUDA tensors (no card, no data)
    gives the shape, dtype and strides of its plain version's output, on the
    fake device."""
    args, want = _case(name, np.random.default_rng(OPS.index(name)))
    kwargs = args.pop() if isinstance(args[-1], dict) else {}
    with FakeTensorMode():
        def fake(a):
            if isinstance(a, torch.Tensor):
                return torch.empty(a.shape, dtype=a.dtype, device="cuda")
            return [fake(t) for t in a] if isinstance(a, list) else a

        out = getattr(torch.ops.mmrp, name)(*map(fake, args), **kwargs)
    assert out.device.type == "cuda"
    assert (tuple(out.shape), out.dtype, out.stride()) == \
        (tuple(want.shape), want.dtype, want.stride())

