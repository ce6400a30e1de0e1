from .ops import NEG, score_topk
from .ref import scoring_ref, topk_ref
from .scoring import CAND_TILE, scoring_cuda, scoring_plain
