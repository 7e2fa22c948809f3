"""The port's pretrained-weight converters and bootstrap against JAX's, on the CPU.

``models/port.py``: each converter's tree array-equal to JAX's converter on
the same state dict (BERT with and without the ``bert.`` prefix of a raw
``BertForPreTraining`` file, Swin with a downsample, MedCLIP full and bare,
the text-only dict rejected); ``text_config_from_state`` and
``swin_layout_from_state`` equal to JAX's; the safetensors reader equal to the
``safetensors`` package; and output for output against HF models built here
from ``transformers`` configs with random init (nothing is downloaded), as
``tests/test_port.py`` holds JAX's: BertModel at atol 2e-4 on unmasked
positions (HF's erf GELU against the tanh form of both packages), SwinModel
at atol 5e-3 with correlation > 0.999999, MedCLIP's composition at 2e-3.

The runner's bootstrap (``train/runner.py``): ``_load_pretrained_backbones``
against JAX's on the same files, one port ``run_training_pipeline`` on a micro
tree from micro pretrained files (its ``model_config.json`` against JAX's
resolution, its towers warm-started, served by ``from_run_dir``), and JAX's
messages for a vocab and a depth mismatch.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from mmrp_tpu.config import Config as JConfig  # noqa: E402
from mmrp_tpu.models import multimodal as jmm  # noqa: E402
from mmrp_tpu.models import port as jport  # noqa: E402
from mmrp_tpu.train import runner as jrunner  # noqa: E402
from mmrp_tpu_torch.config import Config  # noqa: E402
from mmrp_tpu_torch.models import port  # noqa: E402
from mmrp_tpu_torch.models.medclip import MedCLIPVisionEncoder  # noqa: E402
from mmrp_tpu_torch.models.swin import SwinConfig, SwinEncoder  # noqa: E402
from mmrp_tpu_torch.models.text_encoder import TextConfig, TextEncoder  # noqa: E402
from mmrp_tpu_torch.utils.convert import flax_to_state_dict  # noqa: E402
from test_torch_pipeline import TINY, make_tree  # noqa: E402

BERT = dict(vocab_size=211, hidden_size=64, num_hidden_layers=2, num_attention_heads=1,
            intermediate_size=96, max_position_embeddings=64, type_vocab_size=3,
            hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
HF_SWIN = dict(image_size=56, patch_size=4, embed_dim=24, depths=[2, 2], num_heads=[2, 4],
               window_size=7, hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
               drop_path_rate=0.0)
SWIN = dict(img_size=56, embed_dim=24, depths=(2, 2), num_heads=(2, 4), window_size=7,
            drop_path_rate=0.0, dropout=0.0)


def assert_trees_equal(got, want, path=""):
    assert isinstance(got, dict) and got.keys() == want.keys(), path
    for k in want:
        if isinstance(want[k], dict):
            assert_trees_equal(got[k], want[k], f"{path}/{k}")
        else:
            np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=f"{path}/{k}")
            assert got[k].dtype == np.asarray(want[k]).dtype, f"{path}/{k}"


@pytest.fixture(scope="module")
def hf_bert():
    """(BertForPreTraining state dict: ``bert.`` keys and a ``cls.`` head,
    the BertModel's own state dict) of one seeded model."""
    from transformers import BertConfig, BertForPreTraining

    torch.manual_seed(0)
    pre = BertForPreTraining(BertConfig(**BERT)).eval()
    return pre.state_dict(), pre.bert


@pytest.fixture(scope="module")
def hf_swin():
    from transformers import SwinConfig as HFSwinConfig
    from transformers import SwinModel

    torch.manual_seed(1)
    return SwinModel(HFSwinConfig(**HF_SWIN), add_pooling_layer=True).eval()


def test_bert_converter_is_jax_with_and_without_the_prefix(hf_bert):
    raw, bert = hf_bert
    assert any(k.startswith("cls.") for k in raw) and any(k.startswith("bert.") for k in raw)
    bare = bert.state_dict()
    for sd in (raw, bare):
        assert_trees_equal(port.convert_hf_bert(sd, 2), jport.convert_hf_bert(sd, 2))
    assert_trees_equal(port.convert_hf_bert(raw, 2), port.convert_hf_bert(bare, 2))
    for sd in (raw, bare):
        got, want = port.text_config_from_state(sd), jport.text_config_from_state(sd)
        names = {f.name for f in dataclasses.fields(got)} - {"quant"}
        assert {n: getattr(got, n) for n in names} == {n: getattr(want, n) for n in names}
        assert (got.num_heads, got.type_vocab_size, got.num_layers) == (1, 3, 2)


def test_swin_and_medclip_converters_are_jax(hf_swin):
    sd = hf_swin.state_dict()
    assert "encoder.layers.0.downsample.reduction.weight" in sd
    assert_trees_equal(port.convert_hf_swin(sd, (2, 2)), jport.convert_hf_swin(sd, (2, 2)))
    assert port.swin_layout_from_state(sd) == jport.swin_layout_from_state(sd) == \
        ((2, 2), (2, 4))
    w = torch.randn(16, 48)
    full = {f"vision_model.model.{k}": v for k, v in sd.items()}
    full["vision_model.projection_head.weight"] = w
    full["text_model.whatever.weight"] = torch.randn(3, 3)
    bare = {f"model.{k}": v for k, v in sd.items()}
    bare["projection_head.weight"] = w
    for state in (full, bare):
        got = port.convert_medclip_vit(state, depths=(2, 2))
        assert_trees_equal(got, jport.convert_medclip_vit(state, depths=(2, 2)))
    assert_trees_equal(port.convert_medclip_vit(full, (2, 2)),
                       port.convert_medclip_vit(bare, (2, 2)))
    for convert in (port.convert_medclip_vit, jport.convert_medclip_vit):
        with pytest.raises(KeyError, match="no vision tower"):
            convert({"text_model.x": np.zeros((2, 2))})


def test_safetensors_reader_is_the_package(tmp_path):
    """F32, F16, BF16 as f32, and an I64 buffer as int64, equal to
    ``safetensors.torch.load_file``'s tensors; a directory reads its
    ``model.safetensors`` or ``pytorch_model.bin``; a name that is no local
    path raises, fetching nothing."""
    from safetensors.torch import load_file, save_file

    g = torch.Generator().manual_seed(3)
    tensors = {"a.weight": torch.randn(3, 5, generator=g),
               "b": torch.randn(7, generator=g).to(torch.float16),
               "c.bias": torch.randn(2, 2, 2, generator=g).to(torch.bfloat16),
               "position_ids": torch.arange(9)[None]}
    path = tmp_path / "m.safetensors"
    save_file(tensors, str(path), metadata={"format": "pt"})
    got = port.read_safetensors(path)
    want = load_file(str(path))
    assert got.keys() == want.keys()
    for k, v in want.items():
        ref = v.float().numpy() if v.is_floating_point() else v.numpy()
        np.testing.assert_array_equal(got[k], ref, err_msg=k)
        assert got[k].dtype == ref.dtype, k
    d = tmp_path / "hf"
    d.mkdir()
    save_file(tensors, str(d / "model.safetensors"))
    assert port.load_pretrained_state(d).keys() == want.keys()
    (d / "model.safetensors").unlink()
    torch.save(tensors, d / "pytorch_model.bin")
    np.testing.assert_array_equal(port.load_pretrained_state(d)["a.weight"],
                                  tensors["a.weight"].numpy())
    with pytest.raises(FileNotFoundError, match="fetches nothing"):
        port.load_pretrained_state("emilyalsentzer/Bio_ClinicalBERT")
    for load in (port.load_pretrained_state, jport.load_pretrained_state):
        with pytest.raises(FileNotFoundError):
            load(str(tmp_path / "missing.bin"))


def test_bert_port_matches_hf(hf_bert):
    raw, bert = hf_bert
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 211, (2, 10))
    mask = np.ones((2, 10), np.int64)
    mask[1, 6:] = 0
    types = rng.integers(0, 3, (2, 10))
    cfg = port.text_config_from_state(raw, dropout=0.0)
    enc = TextEncoder(cfg, device="cpu").eval()
    enc.load_state_dict(flax_to_state_dict(port.convert_hf_bert(raw, 2)), strict=True)
    with torch.no_grad():
        want = bert(input_ids=torch.tensor(ids), attention_mask=torch.tensor(mask),
                    token_type_ids=torch.zeros_like(torch.tensor(types))).last_hidden_state
        got = enc(torch.tensor(ids), torch.tensor(mask))["tokens"]
    np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), atol=2e-4)
    np.testing.assert_allclose(got[1, :6].numpy(), want[1, :6].numpy(), atol=2e-4)


def test_swin_port_matches_hf(hf_swin):
    img = np.random.default_rng(1).random((2, 56, 56, 3), dtype=np.float32)
    enc = SwinEncoder(SwinConfig(**SWIN), device="cpu").eval()
    enc.load_state_dict(flax_to_state_dict(port.convert_hf_swin(hf_swin.state_dict(), (2, 2))),
                        strict=True)
    with torch.no_grad():
        want = hf_swin(pixel_values=torch.tensor(img.transpose(0, 3, 1, 2)))
        got = enc(torch.from_numpy(img))
    ours, hf = got["patches"].numpy(), want.last_hidden_state.numpy()
    assert ours.shape == hf.shape == (2, 49, 48)
    np.testing.assert_allclose(ours, hf, atol=5e-3)
    assert np.corrcoef(ours.ravel(), hf.ravel())[0, 1] > 0.999999


def test_medclip_port_matches_the_composition(hf_swin):
    """MedCLIP-ViT = HF SwinModel + a bias-free projection: patches ==
    last_hidden_state @ W^T, global == pooler_output @ W^T (2e-3)."""
    w = torch.randn(16, 48, generator=torch.Generator().manual_seed(4)) * 0.1
    state = {f"vision_model.model.{k}": v for k, v in hf_swin.state_dict().items()}
    state["vision_model.projection_head.weight"] = w
    enc = MedCLIPVisionEncoder(SwinConfig(**SWIN), proj_dim=16, device="cpu").eval()
    enc.load_state_dict(flax_to_state_dict(port.convert_medclip_vit(state, (2, 2))),
                        strict=True)
    img = np.random.default_rng(2).random((2, 56, 56, 3), dtype=np.float32)
    with torch.no_grad():
        hf = hf_swin(pixel_values=torch.tensor(img.transpose(0, 3, 1, 2)))
        got = enc(torch.from_numpy(img))
    np.testing.assert_allclose(got["patches"].numpy(), (hf.last_hidden_state @ w.T).numpy(),
                               atol=2e-3)
    np.testing.assert_allclose(got["global"].numpy(), (hf.pooler_output @ w.T).numpy(),
                               atol=2e-3)


# -- the runner's bootstrap ----------------------------------------------------

MICRO_SWIN = dict(image_size=28, patch_size=4, embed_dim=16, depths=[1], num_heads=[2],
                  window_size=7, hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
                  drop_path_rate=0.0)


@pytest.fixture(scope="module")
def pretrained(tmp_path_factory):
    """Micro pretrained files: a raw BertForPreTraining ``.bin``, a SwinModel
    of the micro preset's layout as ``.safetensors``, and the BERT's
    ``vocab.txt``."""
    from safetensors.torch import save_file
    from transformers import BertConfig, BertForPreTraining
    from transformers import SwinConfig as HFSwinConfig
    from transformers import SwinModel

    d = tmp_path_factory.mktemp("pretrained")
    words = ["the", "heart", "is", "normal", "lungs", "clear", "no", "effusion", "mild",
             "cardiomegaly", "."]
    vocab = (["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + words
             + [f"##{c}" for c in "abcdefghijklmnopqrstuvwxyz"])
    (d / "vocab.txt").write_text("\n".join(vocab) + "\n")
    torch.manual_seed(5)
    bert = BertForPreTraining(BertConfig(**dict(BERT, vocab_size=len(vocab),
                                                type_vocab_size=2))).eval()
    torch.save(bert.state_dict(), d / "bert.bin")
    swin = SwinModel(HFSwinConfig(**MICRO_SWIN)).eval()
    save_file({k: v.contiguous() for k, v in swin.state_dict().items()},
              str(d / "swin.safetensors"))
    return d


def micro_cfg(d):
    """``tests/test_torch_pipeline.py``'s tiny config, one epoch, from ``d``'s files."""
    return dict(TINY, epochs=1, pretrained_vocab=str(d / "vocab.txt"),
                pretrained_bert=str(d / "bert.bin"),
                pretrained_swin=str(d / "swin.safetensors"))


def test_load_pretrained_backbones_is_jax(pretrained):
    from mmrp_tpu.data.tokenizer import WordPieceTokenizer as JTokenizer
    from mmrp_tpu_torch.data.tokenizer import WordPieceTokenizer
    from mmrp_tpu_torch.models.multimodal import MultiModalConfig
    from mmrp_tpu_torch.train import runner

    fields = micro_cfg(pretrained)
    cfg, jcfg = Config(**fields), JConfig(**fields)
    tok = WordPieceTokenizer.from_vocab_file(str(pretrained / "vocab.txt"))
    jtok = JTokenizer.from_vocab_file(str(pretrained / "vocab.txt"))
    got = runner._load_pretrained_backbones(cfg, MultiModalConfig.from_config(cfg).swin, tok)
    want = jrunner._load_pretrained_backbones(
        jcfg, jmm.MultiModalConfig.from_config(jcfg).swin, jtok)
    names = {f.name for f in dataclasses.fields(got[0])} - {"quant"}
    assert {n: getattr(got[0], n) for n in names} == {n: getattr(want[0], n) for n in names}
    assert_trees_equal(got[1], want[1])
    assert_trees_equal(got[2], want[2])
    # JAX's checks and messages: the vocab must be the checkpoint's, the Swin
    # layout the configured variant's
    small = pretrained / "small_vocab.txt"
    small.write_text("\n".join((pretrained / "vocab.txt").read_text().split()[:-3]) + "\n")
    bad_tok = (WordPieceTokenizer.from_vocab_file(str(small)),
               JTokenizer.from_vocab_file(str(small)))
    deep = Config(**dict(fields, image_backbone="swin_tiny", image_size=224))
    jdeep = JConfig(**dict(fields, image_backbone="swin_tiny", image_size=224))
    errors = []
    for mod, c, mmc, t in ((runner, cfg, MultiModalConfig, bad_tok[0]),
                           (jrunner, jcfg, jmm.MultiModalConfig, bad_tok[1]),
                           (runner, deep, MultiModalConfig, tok),
                           (jrunner, jdeep, jmm.MultiModalConfig, jtok)):
        with pytest.raises(ValueError) as e:
            mod._load_pretrained_backbones(c, mmc.from_config(c).swin, t)
        errors.append(str(e.value))
    assert errors[0] == errors[1] and "vocab file must be the checkpoint's own" in errors[0]
    assert errors[2] == errors[3] and "pretrained_swin depths (1,)" in errors[2]


def test_bootstrap_run_matches_jax_resolution_and_serves(pretrained, tmp_path):
    """One port run_training_pipeline on a micro tree: model_config.json as
    JAX resolves it (the text tower at the checkpoint's dims), the finetune
    and the joint towers started from the converted weights, and the run
    served by from_run_dir."""
    from mmrp_tpu_torch.api import MMRPredictor
    from mmrp_tpu_torch.train import pipeline as tpipe
    from mmrp_tpu_torch.train import runner
    from mmrp_tpu_torch.train import swin_finetune as tft

    tree = tmp_path / "data"
    make_tree(tree)
    fields = micro_cfg(pretrained)
    cfg = Config(**fields)
    bert_sd = port.load_pretrained_state(pretrained / "bert.bin")
    swin_sd = port.load_pretrained_state(pretrained / "swin.safetensors")
    bert_warm = flax_to_state_dict(port.convert_hf_bert(bert_sd, 2))
    swin_warm = flax_to_state_dict(port.convert_hf_swin(swin_sd, (1,)))
    seen = {}
    real_ft, real_joint = tft.make_finetune_step, tpipe.make_train_step

    def ft_step(model, c, tx):
        step = real_ft(model, c, tx)

        def run(params, *a):
            seen.setdefault("finetune", {k[len("swin."):]: v.clone() for k, v in params.items()
                                         if k.startswith("swin.")})
            return step(params, *a)
        return run

    def joint_step(model, c, pw=None):
        step = real_joint(model, c, pw)

        def run(state, batch):
            seen.setdefault("joint", {k: v.clone() for k, v in state.params.items()})
            return step(state, batch)
        return run

    tft.make_finetune_step, tpipe.make_train_step = ft_step, joint_step
    try:
        runner.run_training_pipeline(cfg, str(tree), str(tmp_path / "run"), device="cpu")
    finally:
        tft.make_finetune_step, tpipe.make_train_step = real_ft, real_joint
    for k, v in swin_warm.items():
        assert torch.equal(seen["finetune"][k], v), k
    ft = flax_to_state_dict(dict(np.load(tmp_path / "run" / "swin" / "swin_backbone.npz")))
    for k, v in ft.items():  # the joint Swin: the finetuned weights, not the raw ones
        assert torch.equal(seen["joint"][f"backbones.swin.{k}"], v), k
    for k, v in bert_warm.items():
        assert torch.equal(seen["joint"][f"backbones.text.{k}"], v), k
    # the converted trees cover their towers
    for tower, warm in (("text", bert_warm), ("swin", ft)):
        assert {k for k in seen["joint"] if k.startswith(f"backbones.{tower}.")} == \
            {f"backbones.{tower}.{k}" for k in warm}
    # model_config.json as JAX writes it for the same resolution
    jcfg = JConfig(**fields)
    text = jport.text_config_from_state(jport.load_pretrained_state(str(pretrained / "bert.bin")))
    jmc = jmm.MultiModalConfig.from_config(dataclasses.replace(
        jcfg, use_pallas_attention=jcfg.train_use_pallas_attention), num_classes=43,
        text_override=text)
    want = {"flagship": False, "vision_backbone": jmc.vision_backbone,
            "text": {k: v for k, v in dataclasses.asdict(jmc.text).items()
                     if k not in ("quant", "remat")}}
    assert json.loads((tmp_path / "run" / "model_config.json").read_text()) == want
    pred = MMRPredictor.from_run_dir(str(tmp_path / "run"), device="cpu")
    assert pred.model.config.text == TextConfig(**{
        k: v for k, v in want["text"].items() if k not in ("use_fused_ffn",
                                                           "use_fused_attention")})
    # each train record's own gallery row at rank 1
    from mmrp_tpu_torch.data.dataset import ChestXRDataset

    recs = {r["id"]: r for r in json.loads((tree / "records_cache.json").read_text())["records"]}
    ids = json.loads((tmp_path / "run" / "train_ids.json").read_text())[:3]
    ds = ChestXRDataset([recs[i] for i in ids], pred_tokenizer(tmp_path / "run"),
                        max_length=16, image_size=28)
    items = [ds[i] for i in range(len(ids))]
    out = pred.predict(np.stack([it["image"] for it in items]),
                       np.stack([it["input_ids"] for it in items]),
                       np.stack([it["attention_mask"] for it in items]), K=1, retrieve=False)
    assert np.isfinite(out["probs"]).all()
    for b, rid in enumerate(ids):
        assert pred.retrieve(out["joint_emb"][b], K=1, rerank=False)[0][0] == rid


def pred_tokenizer(run):
    from mmrp_tpu_torch.data.tokenizer import WordPieceTokenizer

    return WordPieceTokenizer.from_vocab_file(str(run / "vocab.txt"))


def test_runner_raises_for_a_missing_checkpoint(tmp_path):
    from mmrp_tpu_torch.train import runner

    tree = tmp_path / "data"
    make_tree(tree)
    with pytest.raises(FileNotFoundError):
        runner.run_training_pipeline(Config(pretrained_swin=str(tmp_path / "none.bin")),
                                     str(tree), str(tmp_path / "run"), device="cpu")
