from mmrp_tpu_torch.retrieval.gallery import RetrievalEngine, topk_single  # noqa: F401
from mmrp_tpu_torch.retrieval.dls import DLSRetrievalEngine, make_retrieval_engine  # noqa: F401
from mmrp_tpu_torch.retrieval.rerank import Reranker, minmax_scale, label_jaccard  # noqa: F401
