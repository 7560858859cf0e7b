"""The numpy-only control-plane modules the port calls, copied from
``src/repro/core/``: accelerators, workload buckets, the engine model, the
MaxTput profile and the load balancer. The solver is not copied: a
``Profile.to_json`` written here is read by the JAX package's solver."""
