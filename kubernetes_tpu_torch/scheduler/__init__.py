"""The port's scheduler component: the ScheduleAlgorithm
(algorithm.TorchScheduleAlgorithm), the provider registry (plugins,
algorithmprovider), Policy files (policy) and their resolution (factory),
and the inbound scheduler-extender service (extender_server)."""
