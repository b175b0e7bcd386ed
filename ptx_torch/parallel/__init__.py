"""Rendering and the gradient training step over devices (port of
``ptx/parallel``).  One device for now: the mesh and the gradient
allreduce come with ``torch.distributed`` (ROADMAP Queue 1 #9)."""
