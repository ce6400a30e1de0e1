from .pipeline import TokenStream, GraphBatchStream, InteractionStream
