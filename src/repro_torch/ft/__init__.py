from .fault_tolerance import ElasticPlan, HeartbeatMonitor, PackageTiming, StragglerPolicy
