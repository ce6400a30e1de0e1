"""Launch-side data (the reference's ``repro.launch``); so far the recsys
cell shapes. The cell programs wait for a later slice."""
