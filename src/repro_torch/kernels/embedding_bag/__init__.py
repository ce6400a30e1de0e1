from .ops import EmbeddingBagFunction, embedding_bag
from .ref import embedding_bag_ref
from .embedding_bag import bag_index, embedding_bag_cuda, embedding_bag_plain, take_rows, wrap_ids
