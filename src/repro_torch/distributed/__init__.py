"""The mesh: logical sharding rules on a ``torch.distributed`` DeviceMesh
(``sharding``) and re-sharding onto the survivors of a failure
(``elastic``)."""
