from .flash_attention import BLOCK_K, BLOCK_Q, F32_BLOCK_K, F32_BLOCK_Q, flash_attention_cuda, flash_attention_plain
from .ops import flash_attention, flash_attention_gqa
from .ref import attention_ref
