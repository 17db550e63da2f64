"""Serving layer, the PyTorch port of ``repro.serving`` (every module):

simulator.ClusterSim  — discrete-event simulator (queueing, policies)
engine.*ServingEngine — single-unit engines on the device
cluster.ClusterEngine — multi-unit engine with replica routing, fleets
autoscaler.Autoscaler — diurnal elastic-resize policy for the engine
autoscaler.SLAController — measured-p99 feedback resizes
fleet.run_fleet       — several DLRMs on one shared pool
cache.RowCache        — per-CN hot-row embedding cache (LRU/LFU)
scenario.ScenarioSpec — declarative scenarios: typed event timelines,
                        JSON serde, presets, run_scenario front door
scenario_cli          — ``python -m`` entry of the scenario lint/run CLI
timeline.TimelineDispatcher — serve()'s unified event-queue executor
pipeline.ResourceClock — per-resource FIFO timelines + depth-d
                        admission for pipelined batch overlap

Nothing is imported eagerly: import the module you need.
"""
