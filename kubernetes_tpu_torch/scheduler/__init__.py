"""The port's scheduler component: the scheduler cache (cache) and the
scheduling loop (core), the ScheduleAlgorithm (algorithm.
TorchScheduleAlgorithm), the provider registry (plugins,
algorithmprovider), Policy files (policy) and their resolution (factory),
the outbound HTTP extender (extender), the inbound scheduler-extender
service (extender_server) and the gang director (gang)."""
