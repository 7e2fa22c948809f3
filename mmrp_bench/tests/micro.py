"""Micro configurations and traffic for the CPU tests: every width small,
every mechanism present (shifted windows, a patch merge, masked text,
several fusion layers)."""

import copy

from mmrp_bench import harness

MICRO = {
    "name": "micro",
    "vision": {"kind": "swin", "img_size": 56, "patch_size": 4, "in_chans": 3, "embed_dim": 16,
               "depths": [2, 2], "num_heads": [2, 2], "window_size": 7, "mlp_ratio": 4.0},
    "text": {"vocab_size": 8192, "hidden_dim": 32, "num_layers": 2, "num_heads": 2,
             "intermediate_dim": 64, "max_positions": 512, "type_vocab_size": 2},
    "fusion": {"joint_dim": 32, "num_fusion_layers": 2, "num_heads": 2, "max_text_len": 24},
    "num_classes": 43,
    "serve_dtype": "float32",
    "program": {"config": {"image_backbone": "swin_micro", "image_size": 56, "text_dim": 24,
                           "joint_dim": 32, "num_fusion_layers": 2, "num_heads": 2},
                "flagship": False,
                "overrides": {"swin.depths": [2, 2], "swin.num_heads": [2, 2],
                              "text.num_layers": 2}},
    "control": {"program": {"serve_quant": "int8"}},
}


def micro_medclip():
    """MICRO with MedCLIP's projection after the Swin tower."""
    cfg = copy.deepcopy(MICRO)
    cfg["name"] = "micro_medclip"
    cfg["vision"].update(kind="medclip", proj_dim=512)
    cfg["program"]["config"]["image_backbone"] = "medclip"
    cfg["program"]["overrides"].update({"swin.img_size": 56, "swin.embed_dim": 16,
                                        "swin.window_size": 7, "text.hidden_dim": 32,
                                        "text.num_heads": 2, "text.intermediate_dim": 64,
                                        "text.vocab_size": 8192})
    return cfg


def stream_traffic():
    t = harness.traffic_file("stream-openi")
    t.update(batch=4, ring=3, warmup_batches=1, trace_batches=2,
             gallery={"rows": 50, "dim": 32})
    t["text"].update(max_len=24, len_mean=9.0, len_max=24)
    t["image"].update(size=56)
    t["check"].update(sample_batches=2, rows_per_block=2, topk_block=2)
    return t


def train_traffic():
    t = harness.traffic_file("train-openi")
    t.update(batch=4, ring=3, warmup_steps=1, trace_steps=1, kg_dim=8, total_steps=20)
    t["text"].update(max_len=24, len_mean=9.0, len_max=24)
    t["image"].update(size=56)
    t["check"].update(rows_per_block=2)
    return t


def ctx(cfg, traffic, cell, seed=7, seconds=0.5, trace=False, **kw):
    return harness.Ctx(cell=cell, config=cfg, traffic=traffic, limits=harness.limits_file(cell),
                       seed=seed, seconds=seconds, trace=trace, device="cpu", log=lambda s: None,
                       **kw)
