"""repro_torch.launch — meshes, the dry run, the train/serve drivers and
the elastic-restart check.

Do not import `.dryrun` from here: it starts a fake process group in its
`main()`, and runs only as a main module (`python -m
repro_torch.launch.dryrun`).
"""

from .mesh import make_production_mesh, make_smoke_mesh
