from .flash_attention import BLOCK_Q, BLOCK_K, flash_attention_cuda, flash_attention_plain
from .ops import flash_attention, flash_attention_gqa
from .ref import attention_ref
