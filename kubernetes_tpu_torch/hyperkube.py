"""hyperkube (cmd/hyperkube) for the port: the apiserver, the scheduler
daemon and the scheduler-extender service behind one entry point.

    python -m kubernetes_tpu_torch.hyperkube apiserver --port 0
    python -m kubernetes_tpu_torch.hyperkube scheduler --master http://... \
        --device cuda
    python -m kubernetes_tpu_torch.hyperkube extender --port 8090 --device cpu

PyTorch counterpart of kubernetes_tpu/hyperkube.py: `apiserver`
(run_apiserver, the port's copy of the apiserver and its storage
profiles: memory, durable with --data-dir, WAL-shipping primary and
standby, quorum), `scheduler` (run_scheduler, the port's daemon on
--device, the card unless it says cpu; --master is the apiserver's URL,
as --server) and `extender` (run_extender, the port's device program
over the scheduler-extender wire protocol). The other components
(controller-manager, kubelet, proxy, local-up, federation, kubefed) come
with ROADMAP.md queue 1 item 4, which ports the subsystems they run, as
does the JAX hyperkube's KUBERNETES_TPU_PROFILE stack sampler.
"""

from __future__ import annotations

import argparse
import time


def _client(server: str, tls_ca: str = "", insecure: bool = False,
            user: str = "", groups=()):
    from kubernetes_tpu_torch.client.rest import RESTClient
    from kubernetes_tpu_torch.client.transport import HTTPTransport

    return RESTClient(HTTPTransport(server, tls_ca=tls_ca,
                                    insecure=insecure, user=user,
                                    groups=groups))


def _client_from(args, user: str = "", groups=()):
    """Every daemon authenticates with its own system identity so APF
    classification and the audit log see the real caller (the
    reference's per-component kubeconfig users)."""
    return _client(
        args.server,
        tls_ca=getattr(args, "certificate_authority", ""),
        insecure=getattr(args, "insecure_skip_tls_verify", False),
        user=user,
        groups=groups,
    )


def _wait_forever():
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass


def run_apiserver(args) -> None:
    from kubernetes_tpu_torch.apiserver.server import APIServer

    store = None
    monitor = None
    if getattr(args, "store", "") == "quorum":
        # HA profile: this apiserver embeds ONE member of a 3+ node
        # majority-ack consensus store; any member takes client
        # traffic (followers forward writes / barrier reads)
        from kubernetes_tpu_torch.storage.quorum import NodeConfig, QuorumStore

        if not args.data_dir:
            raise SystemExit("--store=quorum requires --data-dir")
        if not args.quorum_id:
            raise SystemExit("--store=quorum requires --quorum-id")
        peers = {}
        for part in (args.quorum_peers or "").split(","):
            part = part.strip()
            if not part:
                continue
            pid, _, addr = part.partition("=")
            pid = pid.strip()
            if pid == args.quorum_id:
                # operators naturally deploy ONE symmetric member
                # list; a node must not count itself as its own peer
                # (majority math and a self-replicator would break)
                continue
            phost, _, pport = addr.rpartition(":")
            peers[pid] = (phost, int(pport))
        store = QuorumStore(NodeConfig(
            node_id=args.quorum_id,
            data_dir=args.data_dir,
            peers=peers,
            listen_port=args.quorum_listen,
            election_timeout=args.quorum_election_timeout,
        )).start()
        print(f"quorum member {args.quorum_id} peering on "
              f"{store.address[0]}:{store.address[1]} "
              f"({len(peers)} peers)", flush=True)
        if not store.wait_leader(60):
            print("warning: no quorum leader emerged within 60s "
                  "(serving anyway; writes 503 until a majority "
                  "connects)", flush=True)
    elif getattr(args, "standby_of", ""):
        # HA standby: WAL-shipped follower + promotion on primary loss
        from kubernetes_tpu_torch.storage.replicated import (
            FollowerStore,
            PromotionMonitor,
        )

        if not args.data_dir:
            raise SystemExit("--standby-of requires --data-dir")
        rhost, _, rport = args.standby_of.rpartition(":")
        store = FollowerStore(args.data_dir, (rhost, int(rport)))
        if not store.synced(60):
            raise SystemExit("standby never completed its initial sync")
        if args.primary_url:
            probe_client = _client(args.primary_url)
            monitor = PromotionMonitor(
                store, probe=probe_client.healthz,
                on_promote=lambda: print("standby PROMOTED", flush=True),
            ).run()
    elif getattr(args, "replicate_listen", None) is not None:
        from kubernetes_tpu_torch.storage.replicated import ReplicatedStore

        if not args.data_dir:
            raise SystemExit("--replicate-listen requires --data-dir")
        store = ReplicatedStore(
            args.data_dir, repl_port=args.replicate_listen
        )
        print(f"replication listener on "
              f"{store.repl_address[0]}:{store.repl_address[1]}",
              flush=True)
    server = APIServer(
        store=store, data_dir=(None if store else args.data_dir or None),
        admission_control=getattr(args, "admission_control", ""),
    )
    host, port = server.serve_http(
        port=args.port,
        tls_cert=args.tls_cert_file,
        tls_key=args.tls_private_key_file,
        max_in_flight=args.max_requests_inflight,
        enable_binary=args.enable_binary_wire,
    )
    scheme_str = "https" if args.tls_cert_file else "http"
    print(f"kube-apiserver listening on {scheme_str}://{host}:{port}",
          flush=True)
    _wait_forever()


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


def run_scheduler(args) -> None:
    """Deviation from kubernetes_tpu/hyperkube.py run_scheduler: the
    daemon schedules on --device (the card unless it says cpu), also
    when a --config file sets the other options."""
    from kubernetes_tpu_torch.scheduler.server import (
        SchedulerServer,
        SchedulerServerOptions,
    )

    if args.config:
        # flags-as-API-object: a versioned KubeSchedulerConfiguration
        # file wins over individual flags (componentconfig idiom)
        options = SchedulerServerOptions.from_config_file(args.config)
    else:
        options = SchedulerServerOptions(
            algorithm_provider=args.algorithm_provider
        )
    options.device = args.device
    if getattr(args, "leader_elect", False):
        # scheduler HA (server.go:140-157): two+ scheduler processes
        # share one lease; the holder schedules, standbys take over
        # when the holder dies or releases
        options.leader_elect = True
        options.leader_elect_identity = args.leader_elect_identity
        options.leader_elect_lease_duration = args.lease_duration
        options.leader_elect_renew_deadline = args.renew_deadline
        options.leader_elect_retry_period = args.retry_period
    if getattr(args, "serve_port", None) is not None:
        options.serve_port = args.serve_port
    sched = SchedulerServer(
        _client_from(args, user="system:kube-scheduler"), options
    ).start()
    print("kube-scheduler running"
          + (" (leader-elect)" if options.leader_elect else ""),
          flush=True)
    _wait_forever()
    sched.stop()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="hyperkube")
    sub = ap.add_subparsers(dest="component", required=True)

    p = sub.add_parser("apiserver")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument(
        "--data-dir", default="",
        help="persist the store here (WAL + snapshot); restarting with "
        "the same dir recovers all state with RV continuity",
    )
    p.add_argument("--tls-cert-file", default="")
    p.add_argument("--tls-private-key-file", default="")
    p.add_argument(
        "--max-requests-inflight", type=int, default=0,
        help="bound concurrent non-watch requests; excess gets 429 "
        "(0 = unlimited)",
    )
    p.add_argument(
        "--enable-binary-wire", action="store_true",
        help="accept/serve the TLV binary content type (kubemark-style "
        "protobuf analogue; data-only, safe for untrusted callers)",
    )
    p.add_argument(
        "--admission-control", default="",
        help="comma-separated admission plugin chain (e.g. "
        "NamespaceLifecycle,AlwaysPullImages,SecurityContextDeny,"
        "LimitRanger,InitialResources,ResourceQuota)",
    )
    p.add_argument(
        "--store", default="", choices=["", "quorum"],
        help="storage profile: '' = single-node (memory, or durable "
        "with --data-dir); 'quorum' = one member of a 3+ node "
        "majority-ack consensus store (leader election, log "
        "replication, linearizable reads; requires --data-dir, "
        "--quorum-id and --quorum-peers)",
    )
    p.add_argument(
        "--quorum-id", default="",
        help="this member's node id in the quorum (e.g. q0)",
    )
    p.add_argument(
        "--quorum-listen", type=int, default=0, metavar="PORT",
        help="peer-RPC listen port for --store=quorum (0 = ephemeral; "
        "fixed ports let peers find each other across restarts)",
    )
    p.add_argument(
        "--quorum-peers", default="", metavar="ID=HOST:PORT,...",
        help="the OTHER quorum members' peer-RPC addresses, e.g. "
        "q1=127.0.0.1:7001,q2=127.0.0.1:7002",
    )
    p.add_argument(
        "--quorum-election-timeout", type=float, default=1.0,
        metavar="SECONDS",
        help="base raft election timeout (etcd-style 1s default; each "
        "reset re-rolls uniform [T, 2T]). The leader-lease window is "
        "a fraction of this, so smaller = faster failover AND shorter "
        "lease reads between renewals",
    )
    p.add_argument(
        "--replicate-listen", type=int, default=None, metavar="PORT",
        help="serve a WAL-shipping replication listener for a standby "
        "(the etcd-cluster property at primary/standby scale; commits "
        "ack only after the standby has them). Requires --data-dir",
    )
    p.add_argument(
        "--standby-of", default="", metavar="HOST:PORT",
        help="run as the replication STANDBY of the primary's "
        "--replicate-listen address; writes 503 until promoted",
    )
    p.add_argument(
        "--primary-url", default="",
        help="with --standby-of: probe this apiserver URL and "
        "self-promote after sustained liveness failures",
    )

    def add_client_flags(p):
        p.add_argument("--server", "-s", default="http://127.0.0.1:8080")
        p.add_argument(
            "--certificate-authority", default="",
            help="CA file pinning a TLS apiserver (kubeconfig idiom)",
        )
        p.add_argument("--insecure-skip-tls-verify", action="store_true")

    p = sub.add_parser("scheduler")
    add_client_flags(p)
    p.add_argument("--master", dest="server", default=argparse.SUPPRESS,
                   help="the apiserver's URL (the same as --server)")
    p.add_argument("--algorithm-provider", default="CUDAProvider")
    p.add_argument(
        "--config", default="",
        help="versioned KubeSchedulerConfiguration file "
        "(componentconfig/v1alpha1); wins over flags",
    )
    p.add_argument(
        "--leader-elect", action="store_true",
        help="participate in kube-scheduler leader election: "
        "only the lease holder schedules; standbys take over "
        "when the holder dies (scheduler HA)",
    )
    p.add_argument("--leader-elect-identity", default="",
                   help="lease holder identity (defaults to a "
                   "per-process id)")
    p.add_argument("--lease-duration", type=float, default=15.0)
    p.add_argument("--renew-deadline", type=float, default=10.0)
    p.add_argument("--retry-period", type=float, default=2.0)
    p.add_argument(
        "--serve-port", type=int, default=None,
        help="observability mux port (/healthz /metrics; "
        "0 = ephemeral, unset = disabled for daemon use)",
    )
    p.add_argument("--device", default="cuda",
                   help="torch device of the scheduler (cpu runs it on "
                   "the host)")

    p = sub.add_parser("extender")
    p.add_argument("--port", type=int, default=8090)
    p.add_argument("--device", default="cuda",
                   help="torch device of the program (cpu runs it on the "
                   "host)")
    args = ap.parse_args(argv)
    {
        "apiserver": run_apiserver,
        "scheduler": run_scheduler,
        "extender": run_extender,
    }[args.component](args)


if __name__ == "__main__":
    main()
