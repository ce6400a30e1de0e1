from .ops import count_into, degree_count
from .ref import degree_count_ref
from .degree_count import degree_count_cuda, degree_count_plain
