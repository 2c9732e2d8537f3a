"""hyperkube (cmd/hyperkube) for the port: the scheduler-extender service.

    python -m kubernetes_tpu_torch.hyperkube extender --port 8090
    python -m kubernetes_tpu_torch.hyperkube extender --port 8090 --device cpu

PyTorch counterpart of kubernetes_tpu/hyperkube.py, `extender` only
(run_extender): it serves the port's device program over the
scheduler-extender wire protocol (scheduler/extender_server.py), on the
card unless --device says otherwise. The other components (apiserver,
scheduler daemon, controller-manager, kubelet, proxy, local-up,
federation) come with the port's daemon slice, which also brings the
control-plane modules they run on.
"""

from __future__ import annotations

import argparse
import time


def _wait_forever():
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass


def run_extender(args) -> None:
    """Serve the port's program as a scheduler-extender HTTP service
    (Filter/Prioritize + bulk ScheduleBacklog) for external schedulers."""
    from kubernetes_tpu_torch.scheduler.extender_server import (
        TorchExtenderServer,
    )

    server = TorchExtenderServer(device=args.device)
    host, port = server.serve_http(port=args.port)
    print(
        f"torch-extender serving Filter/Prioritize/ScheduleBacklog on "
        f"http://{host}:{port}/v1beta1 ({server.device})",
        flush=True,
    )
    _wait_forever()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="hyperkube")
    sub = ap.add_subparsers(dest="component", required=True)
    p = sub.add_parser("extender")
    p.add_argument("--port", type=int, default=8090)
    p.add_argument("--device", default="cuda",
                   help="torch device of the program (cpu runs it on the "
                   "host)")
    args = ap.parse_args(argv)
    {"extender": run_extender}[args.component](args)


if __name__ == "__main__":
    main()
