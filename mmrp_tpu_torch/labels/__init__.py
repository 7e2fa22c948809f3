from mmrp_tpu_torch.labels.taxonomy import (  # noqa: F401
    LabelTaxonomy,
    get_taxonomy,
    LABEL_COLS,
    NUM_CLASSES,
)
