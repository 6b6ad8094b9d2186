"""Interconnect policies of the mesh's stage-1 gathers.

Port of the policy names of ``repro.er.compiler.comms``. Only ``"flat"``
runs in the port so far: the locality planner, the ring and hierarchical
exchanges and their byte accounting come with the mesh (ROADMAP Queue 1
item 10). The service and ``run_er`` validate ``comms`` against these
names, as the JAX package does.
"""

__all__ = ["COMMS_POLICIES"]

COMMS_POLICIES = ("flat", "ring", "hierarchical")
