from mmrp_tpu_torch.kg.sharded_eval import evaluate_sharded, make_sharded_rank_fn  # noqa: F401
