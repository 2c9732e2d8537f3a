"""Volume plugins (pkg/volume analogue).

A VolumePlugin turns a Volume source into setup/teardown operations on a
host path; the registry resolves plugins by spec (plugins.go
VolumePluginMgr.FindPluginBySpec). The mount fabric is a recording fake
(like pkg/util/mount FakeMounter) so hollow nodes can "mount" thousands
of volumes in-process.

Copy of kubernetes_tpu/volume/__init__.py: only the import package differs."""

from kubernetes_tpu_torch.volume.plugins import (
    FakeMounter,
    VolumePlugin,
    VolumePluginMgr,
    default_plugin_mgr,
)

__all__ = [
    "FakeMounter",
    "VolumePlugin",
    "VolumePluginMgr",
    "default_plugin_mgr",
]
