"""Static cluster dashboard (the reference's www/ dashboard, scaled to
its role here: a read-only view of nodes, pods, services, and events
over the JSON API, served by the apiserver at /ui).

Copy of kubernetes_tpu/apiserver/ui.py: only the import package differs."""

from __future__ import annotations

UI_HTML = """<!DOCTYPE html>
<html>
<head>
<meta charset="utf-8">
<title>kubernetes-tpu dashboard</title>
<style>
  body { font-family: system-ui, sans-serif; margin: 2rem; color: #1a1a1a; }
  h1 { font-size: 1.3rem; }
  h2 { font-size: 1.05rem; margin-top: 1.6rem; }
  table { border-collapse: collapse; width: 100%; font-size: 0.9rem; }
  th, td { text-align: left; padding: 0.3rem 0.8rem 0.3rem 0;
           border-bottom: 1px solid #e2e2e2; }
  th { color: #666; font-weight: 600; }
  .ok { color: #0a7d32; }
  .bad { color: #b3261e; }
  #updated { color: #888; font-size: 0.8rem; }
</style>
</head>
<body>
<h1>kubernetes-tpu</h1>
<div id="updated"></div>
<h2>Nodes</h2>
<table id="nodes"><thead><tr><th>name</th><th>ready</th><th>pressure</th>
<th>cpu</th><th>mem</th><th>pods cap</th></tr></thead><tbody></tbody></table>
<h2>Pods</h2>
<table id="pods"><thead><tr><th>namespace</th><th>name</th><th>phase</th>
<th>node</th><th>ip</th></tr></thead><tbody></tbody></table>
<h2>Services</h2>
<table id="services"><thead><tr><th>namespace</th><th>name</th>
<th>clusterIP</th><th>ports</th></tr></thead><tbody></tbody></table>
<h2>Recent events</h2>
<table id="events"><thead><tr><th>type</th><th>reason</th><th>object</th>
<th>message</th></tr></thead><tbody></tbody></table>
<script>
async function fetchList(resource) {
  const r = await fetch("/api/v1/" + resource);
  if (!r.ok) return [];
  return (await r.json()).items || [];
}
function fill(id, rows) {
  const tb = document.querySelector("#" + id + " tbody");
  tb.innerHTML = "";
  for (const cells of rows) {
    const tr = document.createElement("tr");
    for (const c of cells) {
      const td = document.createElement("td");
      if (typeof c === "object") { td.textContent = c.text; td.className = c.cls; }
      else td.textContent = c;
      tr.appendChild(td);
    }
    tb.appendChild(tr);
  }
}
function cond(conds, type) {
  for (const c of conds || []) if (c.type === type) return c.status;
  return "";
}
async function refresh() {
  const [nodes, pods, services, events] = await Promise.all([
    fetchList("nodes"), fetchList("pods"), fetchList("services"),
    fetchList("events"),
  ]);
  fill("nodes", nodes.map(n => [
    n.metadata.name,
    {text: cond(n.status.conditions, "Ready"),
     cls: cond(n.status.conditions, "Ready") === "True" ? "ok" : "bad"},
    cond(n.status.conditions, "MemoryPressure") === "True"
      ? {text: "memory", cls: "bad"} : "",
    (n.status.allocatable || {}).cpu || "",
    (n.status.allocatable || {}).memory || "",
    (n.status.allocatable || {}).pods || "",
  ]));
  fill("pods", pods.map(p => [
    p.metadata.namespace, p.metadata.name,
    {text: p.status.phase,
     cls: p.status.phase === "Running" ? "ok"
        : p.status.phase === "Failed" ? "bad" : ""},
    p.spec.nodeName || "", p.status.podIp || "",
  ]));
  fill("services", services.map(s => [
    s.metadata.namespace, s.metadata.name, s.spec.clusterIp || "",
    (s.spec.ports || []).map(p => p.port).join(","),
  ]));
  events.sort((a, b) =>
    (a.lastTimestamp || a.metadata.creationTimestamp || "")
      .localeCompare(b.lastTimestamp || b.metadata.creationTimestamp || ""));
  fill("events", events.slice(-25).reverse().map(e => [
    {text: e.type || "", cls: e.type === "Warning" ? "bad" : ""},
    e.reason || "",
    ((e.involvedObject || {}).namespace || "") + "/" +
      ((e.involvedObject || {}).name || ""),
    e.message || "",
  ]));
  document.getElementById("updated").textContent =
    "updated " + new Date().toLocaleTimeString();
}
refresh();
setInterval(refresh, 2000);
</script>
</body>
</html>
"""
