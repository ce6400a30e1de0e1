from .ops import embedding_bag
from .ref import embedding_bag_ref
from .embedding_bag import bag_index, embedding_bag_cuda, embedding_bag_plain
