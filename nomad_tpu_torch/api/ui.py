"""Minimal operator web UI, served at ``/ui``.

The reference ships a full Ember SPA (``ui/``, reference repo); this is a
deliberately small, dependency-free single page over the same ``/v1``
APIs — jobs, allocations, nodes, deployments, evaluations, volumes,
members — with auto-refresh.  It exists so the HTTP surface has a human
face, not to replicate the Ember app.
"""

UI_HTML = """<!doctype html>
<html>
<head>
<meta charset="utf-8">
<title>nomad_tpu</title>
<style>
  :root { color-scheme: light dark; }
  body { font: 13px/1.5 -apple-system, system-ui, sans-serif; margin: 0;
         background: Canvas; color: CanvasText; }
  header { display: flex; align-items: baseline; gap: 1rem;
           padding: .6rem 1rem; border-bottom: 1px solid color-mix(in srgb, CanvasText 18%, Canvas); }
  header h1 { font-size: 1rem; margin: 0; }
  header span { opacity: .65; font-size: .8rem; }
  nav button { margin-right: .4rem; padding: .25rem .7rem; cursor: pointer;
               border: 1px solid color-mix(in srgb, CanvasText 25%, Canvas);
               background: transparent; color: inherit; border-radius: 4px; }
  nav button.on { background: color-mix(in srgb, CanvasText 12%, Canvas); font-weight: 600; }
  main { padding: .8rem 1rem; }
  table { border-collapse: collapse; width: 100%; }
  th, td { text-align: left; padding: .25rem .6rem;
           border-bottom: 1px solid color-mix(in srgb, CanvasText 12%, Canvas); }
  th { opacity: .7; font-weight: 600; }
  tr:hover td { background: color-mix(in srgb, CanvasText 6%, Canvas); }
  .mono { font-family: ui-monospace, monospace; font-size: 12px; }
  .ok { color: #2e9e44; } .bad { color: #d43d2a; } .warn { color: #c98a00; }
  #err { color: #d43d2a; padding: .3rem 1rem; }
</style>
</head>
<body>
<header>
  <h1>nomad_tpu</h1>
  <nav id="tabs"></nav>
  <input id="token" type="password" placeholder="ACL token"
         style="margin-left:auto; padding:.2rem .4rem; font-size:.8rem;">
  <span id="meta"></span>
</header>
<div id="err"></div>
<main id="main">loading…</main>
<script>
const TABS = ["jobs", "allocations", "nodes", "deployments",
              "evaluations", "volumes", "members"];
let tab = location.hash.slice(1) || "jobs";

async function j(path) {
  const token = localStorage.getItem("nomad_tpu_token") || "";
  const r = await fetch(path, token ? {
    headers: {"X-Nomad-Token": token}
  } : {});
  if (!r.ok) throw new Error(path + " -> " + r.status);
  return r.json();
}
function h(s) {
  return String(s ?? "").replace(/[&<>"]/g,
    c => ({"&":"&amp;","<":"&lt;",">":"&gt;",'"':"&quot;"}[c]));
}
function cls(s) {
  if (["running","ready","complete","successful","alive"].includes(s)) return "ok";
  if (["failed","lost","down","dead"].includes(s)) return "bad";
  return "warn";
}
function table(cols, rows) {
  return "<table><tr>" + cols.map(c => `<th>${h(c)}</th>`).join("") +
    "</tr>" + rows.map(r => "<tr>" + r.map(c => `<td>${c}</td>`).join("") +
    "</tr>").join("") + "</table>";
}
const short = id => `<span class=mono title="${h(id)}">${h(String(id).slice(0, 8))}</span>`;
const st = s => `<span class="${cls(s)}">${h(s)}</span>`;

const RENDER = {
  async jobs() {
    const jobs = await j("/v1/jobs");
    return table(["ID", "Type", "Priority", "Status", "Version"],
      jobs.map(x => [h(x.id), h(x.type), x.priority,
                     st(x.status) + (x.stop ? " (stopped)" : ""), x.version]));
  },
  async allocations() {
    const allocs = await j("/v1/allocations");
    return table(["ID", "Job", "Group", "Node", "Desired", "Status"],
      allocs.map(a => [short(a.id), h(a.job_id), h(a.task_group),
                       short(a.node_id), h(a.desired_status),
                       st(a.client_status)]));
  },
  async nodes() {
    const nodes = await j("/v1/nodes");
    return table(["ID", "Name", "DC", "Class", "Status", "Eligibility"],
      nodes.map(n => [short(n.id), h(n.name), h(n.datacenter),
                      h(n.node_class), st(n.status),
                      h(n.scheduling_eligibility) +
                      (n.drain ? " (draining)" : "")]));
  },
  async deployments() {
    const deps = await j("/v1/deployments");
    return table(["ID", "Job", "Version", "Status", "Description"],
      deps.map(d => [short(d.id), h(d.job_id), "v" + d.job_version,
                     st(d.status), h(d.status_description)]));
  },
  async evaluations() {
    const evs = await j("/v1/evaluations");
    return table(["ID", "Job", "Triggered by", "Status"],
      evs.slice(-200).reverse().map(e => [short(e.id), h(e.job_id),
                                          h(e.triggered_by), st(e.status)]));
  },
  async volumes() {
    const vols = await j("/v1/volumes");
    return table(["ID", "Source", "Access mode", "Writers", "Readers"],
      vols.map(v => [h(v.id), h(v.source), h(v.access_mode),
                     Object.keys(v.write_claims).length,
                     Object.keys(v.read_claims).length]));
  },
  async members() {
    const out = await j("/v1/agent/members");
    return table(["Name", "Addr", "Status", "Leader"],
      out.Members.map(m => [h(m.Name), h(m.Addr || ""), st(m.Status),
                            m.Leader ? "yes" : ""]));
  },
};

function drawTabs() {
  document.getElementById("tabs").innerHTML = TABS.map(t =>
    `<button class="${t === tab ? "on" : ""}" onclick="go('${t}')">${t}</button>`
  ).join("");
}
function go(t) { tab = t; location.hash = t; drawTabs(); refresh(); }
async function refresh() {
  const err = document.getElementById("err");
  try {
    document.getElementById("main").innerHTML = await RENDER[tab]();
    err.textContent = "";
    document.getElementById("meta").textContent =
      new Date().toLocaleTimeString();
  } catch (e) { err.textContent = String(e); }
}
const tokenBox = document.getElementById("token");
tokenBox.value = localStorage.getItem("nomad_tpu_token") || "";
tokenBox.addEventListener("change", () => {
  localStorage.setItem("nomad_tpu_token", tokenBox.value);
  refresh();
});
drawTabs();
refresh();
setInterval(refresh, 3000);
</script>
</body>
</html>
"""
