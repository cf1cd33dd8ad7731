from seqrec_tpu_torch.models.model import SeqRecModel, build_model  # noqa: F401
from seqrec_tpu_torch.models.towers import RNNTower, SASRecTower  # noqa: F401
