"""Launchers and cell programs (the reference's ``repro.launch``): the cell
shapes, steps and cell programs (``steps``), the mesh descriptions
(``mesh``), the dry-run (``dryrun``), and the serving and training
launchers."""
