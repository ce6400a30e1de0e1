"""Launchers and cell programs (the reference's ``repro.launch``): the cell
shapes, the LM train step, and the serving and training launchers. The
dry-run's cell programs wait for a later slice."""
