"""Multi-device training and evaluation on ``torch.distributed``: one process
per device, the entity table row-sharded over a ``DeviceMesh``."""
