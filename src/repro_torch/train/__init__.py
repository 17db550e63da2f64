"""Single-device training: optimizers, the train step and its
fault-tolerant loop, checkpoints (the counterpart of ``repro.train``)."""
