"""Client layer (reference: pkg/client).

- transport: LocalTransport (in-process handle()) / HTTPTransport
- rest: RESTClient — typed verbs + QPS/burst throttling
  (pkg/client/restclient + util/flowcontrol)
- cache: Reflector / FIFO / DeltaFIFO / Store / Indexer / listers
  (pkg/client/cache)
- informer: controller framework + SharedIndexInformer
  (pkg/controller/framework)
- record: event broadcaster/recorder (pkg/client/record)
- leaderelection: lease via Endpoints annotation CAS
  (pkg/client/leaderelection)

Copy of kubernetes_tpu/client/__init__.py: only the import package differs.
"""

from kubernetes_tpu_torch.client.rest import RESTClient
from kubernetes_tpu_torch.client.transport import HTTPTransport, LocalTransport

__all__ = ["RESTClient", "LocalTransport", "HTTPTransport"]
