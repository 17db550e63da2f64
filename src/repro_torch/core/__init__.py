"""DisaggRec core, as far as the cluster serving path needs it:
hardware constants, the ingress batcher, embedding management, failure
costs and the analytic serving-unit model.  Nothing is imported eagerly."""
