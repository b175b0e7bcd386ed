"""Rendering and the gradient training step over devices (port of
``ptx/parallel``): the (tiles × samples) mesh on ``torch.distributed``
(:mod:`.mesh`, :mod:`.dist`), the sharded renders and the train step
(:mod:`.render`), the checkpoints (:mod:`.checkpoint`)."""
