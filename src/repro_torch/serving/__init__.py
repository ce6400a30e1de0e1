from .engine import DECODE_STEP, plan_group_width
