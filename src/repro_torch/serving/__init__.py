"""Serving layer ported so far: the single-unit DLRM engine, the
cluster engine with its hot-row cache and pipelined virtual clock, the
event timeline and the declarative scenario front door.  Nothing is
imported eagerly: import the module you need."""
