from .engine import DECODE_STEP, Request, ServingEngine, plan_group_width
