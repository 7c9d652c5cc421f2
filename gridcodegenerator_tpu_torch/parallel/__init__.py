"""The port's multi-device layer over ``torch.distributed``: meshes of
ranks (``mesh.py``), their collectives (``collectives.py``), the
knot-sharded Riccati reduce (``knot_riccati.py``), scenario-tree MPC on one
device or a mesh (``scenario.py``), and a group of spawned local ranks
with time limits (``launch.py``)."""
