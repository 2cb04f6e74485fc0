"""Training dashboard web server (counterpart of
deeplearning4j_tpu/ui/server.py: host only, the same page and the same
JSON for the same storage contents).

Parity: deeplearning4j-play PlayUIServer.java (:53, singleton
``getInstance`` :24, ``--uiPort`` flag) + the train-module charts. The
reference runs a Play 2.x app polling StatsStorage; here a stdlib
ThreadingHTTPServer serves a self-contained HTML/JS page (no external
assets — works in zero-egress environments) that polls JSON endpoints
backed by any attached ``BaseStatsStorage``:

- ``GET /``                                    dashboard page
- ``GET /api/sessions``                        session/worker inventory
- ``GET /api/updates?session=S[&after=T]``     score/timing series
- ``GET /api/model?session=S``                 latest param/update stats
- ``GET /metrics``                             unified registry (JSON;
  Prometheus text with ``Accept: text/plain`` or ``?format=prometheus``)
- ``GET /api/trace``                           Chrome trace-event JSON of
  the process-global span tracer (loadable in Perfetto)
- ``GET /api/traces``                          trace ids with pushed
  request-scoped spans (the waterfall panel's inventory)
- ``GET /api/trace/<id>``                      stitched cross-process
  waterfall for one request trace (OBSERVABILITY.md §Request tracing)

Use::

    server = UIServer.get_instance(port=9000)
    server.attach(storage)     # any InMemory/FileStatsStorage
    ...
    server.stop()
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional
from urllib.parse import parse_qs, urlparse

# the distributed trainers' phase -> color map the timeline card and the
# exported timeline share
from deeplearning4j_tpu_torch.parallel.stats import PHASE_COLORS
from deeplearning4j_tpu_torch.ui.storage import BaseStatsStorage


_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>deeplearning4j-tpu training UI</title>
<style>
body{font-family:system-ui,sans-serif;margin:0;background:#fafafa;color:#222}
header{background:#1a237e;color:#fff;padding:10px 18px;font-size:18px}
.row{display:flex;flex-wrap:wrap;gap:14px;padding:14px}
.card{background:#fff;border:1px solid #ddd;border-radius:6px;padding:12px;
      min-width:420px;flex:1}
h3{margin:2px 0 8px;font-size:14px;color:#444}
svg{width:100%;height:220px}
table{border-collapse:collapse;font-size:12px;width:100%}
td,th{border-bottom:1px solid #eee;padding:3px 6px;text-align:right}
th:first-child,td:first-child{text-align:left}
select{margin-left:12px}
.stat{font-size:22px;font-weight:600}
.label{font-size:11px;color:#777}
</style></head><body>
<header>deeplearning4j-tpu — training dashboard
<select id="session"></select></header>
<div class="row">
 <div class="card"><h3>Score vs iteration</h3><svg id="score"></svg></div>
 <div class="card"><h3>Iteration time (ms) / examples-sec</h3>
   <svg id="perf"></svg></div>
</div>
<div class="row">
 <div class="card"><h3>Latest</h3><div id="latest"></div></div>
 <div class="card"><h3>Parameter mean magnitudes (latest)</h3>
   <div id="model"></div></div>
</div>
<div class="row">
 <div class="card"><h3>Parameter histogram
   <select id="histparam"></select>
   <select id="histkind"><option value="param">weights</option>
     <option value="update">updates</option>
     <option value="activation">activations</option></select></h3>
   <svg id="hist"></svg></div>
 <div class="card" id="embcard" style="display:none">
   <h3>Embedding map (t-SNE)</h3><svg id="emb" style="height:320px"></svg>
 </div>
 <div class="card" id="flowcard" style="display:none">
   <h3>Model flow</h3><svg id="flow" style="height:auto"></svg>
 </div>
</div>
<div class="row">
 <div class="card" id="phasecard" style="display:none">
   <h3>Phase timeline (per worker)</h3><svg id="phases"
    style="height:auto"></svg><div id="phaselegend" class="label"></div>
 </div>
</div>
<div class="row">
 <div class="card" id="tracecard" style="display:none">
   <h3>Runtime trace (per thread, recent window)</h3><svg id="trace"
    style="height:auto"></svg><div id="tracelegend" class="label"></div>
 </div>
</div>
<div class="row">
 <div class="card" id="goodputcard" style="display:none">
   <h3>Goodput &amp; efficiency <span id="goodputsrc" class="label"></span>
   </h3><div id="goodputstats"></div><svg id="goodputbar"
    style="height:34px"></svg><div id="goodputlegend" class="label"></div>
 </div>
</div>
<div class="row">
 <div class="card" id="fleetcard" style="display:none">
   <h3>Fleet health <span id="fleetsummary" class="label"></span></h3>
   <div id="fleettable"></div>
 </div>
</div>
<div class="row">
 <div class="card" id="wfcard" style="display:none">
   <h3>Request waterfall <select id="wfselect"></select>
     <span id="wfmeta" class="label"></span></h3>
   <svg id="wfsvg" style="height:auto"></svg>
   <div id="wflegend" class="label"></div>
 </div>
</div>
<script>
const COLORS=["#1a73e8","#e8710a","#188038","#d93025","#9334e6","#12858d"];
function esc(s){ return String(s).replace(/&/g,"&amp;").replace(/</g,"&lt;")
  .replace(/>/g,"&gt;").replace(/"/g,"&quot;"); }
function lines(svg, seriesList){
  // seriesList: [{xs, ys, color, label}] — one polyline per worker
  const el = document.getElementById(svg); el.innerHTML = "";
  const allx=[], ally=[];
  seriesList.forEach(s=>{ s.xs.forEach((x,i)=>{
    if(Number.isFinite(s.ys[i])){ allx.push(x); ally.push(s.ys[i]); }});});
  if (allx.length < 2) return;
  const W = el.clientWidth || 480, H = el.clientHeight || 220, P = 30;
  const xmin=Math.min(...allx), xmax=Math.max(...allx);
  const ymin=Math.min(...ally), ymax=Math.max(...ally);
  const sx=x=>P+(W-2*P)*(x-xmin)/Math.max(xmax-xmin,1e-9);
  const sy=y=>H-P-(H-2*P)*(y-ymin)/Math.max(ymax-ymin,1e-9);
  let html =
   `<line x1="${P}" y1="${H-P}" x2="${W-P}" y2="${H-P}" stroke="#bbb"/>`+
   `<line x1="${P}" y1="${P}" x2="${P}" y2="${H-P}" stroke="#bbb"/>`+
   `<text x="${P}" y="${P-6}" font-size="10" fill="#888">`+
     `${ymax.toPrecision(4)}</text>`+
   `<text x="${P}" y="${H-P+12}" font-size="10" fill="#888">`+
     `${ymin.toPrecision(4)}</text>`;
  seriesList.forEach((s, k)=>{
    let d="";
    s.xs.forEach((x,i)=>{ if(Number.isFinite(s.ys[i]))
        d += (d?"L":"M")+sx(x).toFixed(1)+","+sy(s.ys[i]).toFixed(1); });
    html += `<path d="${d}" fill="none" stroke="${s.color}"`+
            ` stroke-width="1.6"/>`;
    if (s.label) html += `<text x="${W-P-70}" y="${P+12*(k+1)}"`+
        ` font-size="10" fill="${s.color}">${esc(s.label)}</text>`;
  });
  el.innerHTML = html;
}
function workerSeries(u, field){
  const ws = Object.keys(u.workers || {}).sort();
  if (ws.length > 1)
    return ws.map((w,k)=>({xs:u.workers[w].iterations,
      ys:u.workers[w][field], color:COLORS[k%COLORS.length], label:w}));
  return [{xs:u.iterations, ys:u[field==="scores"?"scores":"iteration_ms"],
           color:COLORS[field==="scores"?0:1]}];
}
async function refresh(){
  await refreshFleet();   // fleet scoreboard lives without any session
  await refreshWaterfall();  // so does the request-trace waterfall
  const sess = document.getElementById("session").value;
  if (!sess) return;
  const u = await (await fetch("/api/updates?session="+
                   encodeURIComponent(sess))).json();
  lines("score", workerSeries(u, "scores"));
  lines("perf", workerSeries(u, "iteration_ms"));
  const last = u.latest;
  if (last) document.getElementById("latest").innerHTML =
    `<span class="stat">${Number(last.score).toPrecision(5)}</span>
     <span class="label">score</span> &nbsp;
     <span class="stat">${last.iteration}</span>
     <span class="label">iteration</span> &nbsp;
     <span class="stat">${last.examples_per_sec ?
        Math.round(last.examples_per_sec) : "—"}</span>
     <span class="label">examples/sec</span> &nbsp;
     <span class="stat">${last.memory_rss_mb ?
        Math.round(last.memory_rss_mb) : "—"}</span>
     <span class="label">host MB</span>`;
  const m = await (await fetch("/api/model?session="+
                   encodeURIComponent(sess))).json();
  let rows = "<table><tr><th>parameter</th><th>mean |w|</th>" +
             "<th>mean |Δw|</th><th>Δ ratio</th></tr>";
  for (const [k, v] of Object.entries(m.param_stats || {})){
    const up = (m.update_stats||{})[k] || {};
    const ratio = up.mean_magnitude && v.mean_magnitude ?
      (up.mean_magnitude/v.mean_magnitude).toExponential(2) : "—";
    rows += `<tr><td>${esc(k)}</td><td>${v.mean_magnitude.toExponential(3)}</td>
      <td>${up.mean_magnitude ? up.mean_magnitude.toExponential(3) : "—"}</td>
      <td>${ratio}</td></tr>`;
  }
  document.getElementById("model").innerHTML = rows + "</table>";
  renderHistogram(m);
  await refreshEmbedding(sess, m.embedding_version ?? null);
  await refreshFlow(sess, m.activation_stats || {});
  await refreshPhases(sess);
  await refreshTrace();
  await refreshGoodput();
}
async function refreshGoodput(){
  // the efficiency ledger next to the trace timeline: headline gauges
  // (goodput %, MFU, FLOP/s, steps) + a single stacked wall-time bar
  // attributing the run across traced phases (/api/goodput serves the
  // live ledger during a run, the last RunReport after it)
  const g = await (await fetch("/api/goodput")).json();
  const card = document.getElementById("goodputcard");
  if (!g || g.source === "none" || !g.wall_s){
    card.style.display = "none"; return; }
  card.style.display = "";
  document.getElementById("goodputsrc").textContent =
    `(${g.kind || "run"} · ${g.source === "live" ? "live" : "last run"})`;
  const pct = v => v == null ? "—" : (100*v).toFixed(1)+"%";
  const num = v => v == null ? "—" : Number(v).toPrecision(3);
  document.getElementById("goodputstats").innerHTML =
    `<span class="stat">${pct(g.goodput_fraction)}</span>
     <span class="label">goodput</span> &nbsp;
     <span class="stat">${pct(g.mfu)}</span>
     <span class="label">MFU</span> &nbsp;
     <span class="stat">${g.flops_per_second ?
        num(g.flops_per_second/1e9)+" G" : "—"}</span>
     <span class="label">FLOP/s</span> &nbsp;
     <span class="stat">${g.steps ?? "—"}</span>
     <span class="label">steps</span> &nbsp;
     <span class="stat">${num(g.wall_s)}s</span>
     <span class="label">wall</span>`;
  const phases = g.phases || {};
  const names = Object.keys(phases).sort(
    (a,b)=>phases[b].seconds - phases[a].seconds);
  const el = document.getElementById("goodputbar");
  if (!names.length){ el.innerHTML = "";
    document.getElementById("goodputlegend").innerHTML = ""; return; }
  const W = el.clientWidth || 760, H = 34;
  el.setAttribute("viewBox", `0 0 ${W} ${H}`);
  let x = 0, html = "";
  const total = Math.max(g.wall_s, 1e-9);
  names.forEach(n=>{
    const w = W * phases[n].seconds / total;
    html += `<rect x="${x.toFixed(1)}" y="4" width="${Math.max(w,0.5)
      .toFixed(1)}" height="${H-8}" fill="${spanColor(n)}"`+
      ` fill-opacity="0.85"><title>${esc(n)} ${phases[n].seconds
      .toFixed(3)}s</title></rect>`;
    x += w;
  });
  if (x < W) html += `<rect x="${x.toFixed(1)}" y="4" width="${(W-x)
    .toFixed(1)}" height="${H-8}" fill="#ddd">`+
    `<title>untracked</title></rect>`;
  el.innerHTML = html;
  document.getElementById("goodputlegend").innerHTML =
    names.map(n=>`<span style="color:${spanColor(n)}">&#9632; `+
      `${esc(n)} ${phases[n].seconds.toFixed(2)}s</span>`).join(" &nbsp;")+
    ' <span style="color:#999">&#9632; untracked</span>';
}
async function refreshFleet(){
  // /api/fleet health scoreboard: one row per pushing instance —
  // liveness from heartbeat age, readiness from the pushed health
  // flags, queue depth + fit-step progress for routing decisions
  const f = await (await fetch("/api/fleet")).json();
  const card = document.getElementById("fleetcard");
  const rows = f.instances || [];
  if (!rows.length){ card.style.display = "none"; return; }
  card.style.display = "";
  document.getElementById("fleetsummary").textContent =
    `(${f.ready}/${rows.length} ready, stale after ${f.stale_after_s}s)`;
  const dot = ok => `<span style="color:${ok?'#188038':'#d93025'}">`+
    `${ok?'&#9679;':'&#9675;'}</span>`;
  let html = "<table><tr><th>instance</th><th>live</th><th>ready</th>"+
    "<th>heartbeat age s</th><th>queue</th><th>steps</th>"+
    "<th>progress age s</th><th>pushes</th></tr>";
  rows.forEach(r=>{
    html += `<tr><td>${esc(r.instance)}</td><td>${dot(r.live)}</td>`+
      `<td>${dot(r.ready)}</td><td>${r.heartbeat_age_s}</td>`+
      `<td>${r.queue_depth ?? "—"}</td>`+
      `<td>${r.steps_total ?? "—"}</td>`+
      `<td>${r.last_progress_age_s ?? "—"}</td>`+
      `<td>${r.pushes}</td></tr>`;
  });
  html += "</table>";
  // cross-host routing table: a FrontDoorRouter pushing here carries
  // its per-host routing rows in the health payload (serving/router.py)
  const routers = rows.filter(
    r => r.health && Array.isArray(r.health.routing));
  routers.forEach(R=>{
    html += `<h4 style="margin:8px 0 4px">Routing table `+
      `<span class="label">(router ${esc(R.instance)})</span></h4>`+
      "<table><tr><th>host</th><th>routable</th><th>queue</th>"+
      "<th>in flight</th><th>picks</th><th>retry-after s</th>"+
      "<th>heartbeat age s</th></tr>";
    R.health.routing.forEach(h=>{
      html += `<tr><td>${esc(h.instance || h.url)}</td>`+
        `<td>${dot(h.routable)}</td><td>${h.queue_depth ?? "—"}</td>`+
        `<td>${h.in_flight}</td><td>${h.picks}</td>`+
        `<td>${h.retry_after_s ?? "—"}</td>`+
        `<td>${h.heartbeat_age_s ?? "—"}</td></tr>`;
    });
    html += "</table>";
  });
  document.getElementById("fleettable").innerHTML = html;
}
async function refreshWaterfall(){
  // stitched per-request waterfall: trace ids arrive with the hosts'
  // span pushes (/api/traces inventory); /api/trace/<id> serves the
  // clock-skew-rebased segment list (queue_wait / batch_assembly /
  // device_compute / network) this card draws as one horizontal lane
  // per segment on the request's own time axis
  const card = document.getElementById("wfcard");
  let ids = [];
  try {
    const t = await (await fetch("/api/traces")).json();
    ids = (t.traces || []).slice().reverse();  // most recent first
  } catch (e) { ids = []; }
  if (!ids.length){ card.style.display = "none"; return; }
  card.style.display = "";
  const sel = document.getElementById("wfselect");
  const cur = Array.from(sel.options).map(o=>o.value);
  if (JSON.stringify(cur) !== JSON.stringify(ids)){
    const v = sel.value;
    sel.innerHTML = ids.map(x=>`<option>${esc(x)}</option>`).join("");
    sel.value = ids.includes(v) ? v : ids[0];
  }
  const wf = await (await fetch("/api/trace/"+
      encodeURIComponent(sel.value))).json();
  if (!wf.found){ card.style.display = "none"; return; }
  document.getElementById("wfmeta").textContent =
    `(${(wf.instances||[]).join(", ")} · total ${wf.total_ms} ms)`;
  const segs = wf.segments || [];
  const el = document.getElementById("wfsvg");
  const W = el.clientWidth || 760, LH = 18, P = 200, TP = 4;
  const H = TP*2 + segs.length*LH + 16;
  el.setAttribute("viewBox", `0 0 ${W} ${H}`);
  el.style.height = H + "px";
  const total = Math.max(wf.total_ms, 1e-9);
  const sx = ms=>P + (W - P - 10) * ms / total;
  let html = "";
  segs.forEach((s, i)=>{
    const y = TP + i*LH;
    html += `<text x="${P-6}" y="${y+LH/2+3}" font-size="9"`+
      ` text-anchor="end">${esc(s.instance+" · "+s.name)}</text>`+
      `<rect x="${sx(s.start_ms).toFixed(1)}" y="${y+2}"`+
      ` width="${Math.max(sx(s.start_ms+s.dur_ms)-sx(s.start_ms),0.8)
        .toFixed(1)}" height="${LH-5}"`+
      ` fill="${spanColor(s.name)}" fill-opacity="0.85">`+
      `<title>${esc(s.name)} ${s.dur_ms.toFixed(2)} ms `+
      `(${esc(s.instance)})</title></rect>`;
  });
  html += `<text x="${P}" y="${H-2}" font-size="10" fill="#888">`+
    `0 ms</text>`+
    `<text x="${W-80}" y="${H-2}" font-size="10" fill="#888">`+
    `${total.toFixed(1)} ms</text>`;
  el.innerHTML = html;
  document.getElementById("wflegend").innerHTML =
    Object.entries(wf.summary_ms || {}).map(([n, ms])=>
      `<span style="color:${spanColor(n)}">&#9632; ${esc(n)} `+
      `${ms.toFixed(2)} ms</span>`).join(" &nbsp;");
}
document.getElementById("wfselect").onchange = refreshWaterfall;
const TRACE_PALETTE=["#1f77b4","#ff7f0e","#2ca02c","#d93025","#9334e6",
  "#8c564b","#e377c2","#7f7f7f","#bcbd22","#12858d"];
function spanColor(name){
  let h = 0;
  for (let i = 0; i < name.length; i++) h = (h*31 + name.charCodeAt(i))>>>0;
  return TRACE_PALETTE[h % TRACE_PALETTE.length];
}
async function refreshTrace(){
  // per-thread span lanes from the process-global tracer (/api/trace is
  // the same Chrome trace-event payload Perfetto loads: "M" metadata
  // events carry thread names, "X" events carry ts/dur in microseconds)
  const t = await (await fetch("/api/trace")).json();
  const evs = (t.traceEvents || []);
  const names = {}, byTid = {};
  evs.forEach(e=>{
    if (e.ph === "M" && e.name === "thread_name")
      names[e.tid] = e.args.name;
    else if (e.ph === "X")
      (byTid[e.tid] = byTid[e.tid] || []).push(e);
  });
  const tids = Object.keys(byTid).sort(
    (a,b)=>(names[a]||a).localeCompare(names[b]||b));
  const card = document.getElementById("tracecard");
  if (!tids.length){ card.style.display = "none"; return; }
  card.style.display = "";
  // render only the recent window — the ring can hold 64k spans
  let tmax = 0;
  tids.forEach(tid=>byTid[tid].forEach(e=>{
    tmax = Math.max(tmax, e.ts + e.dur); }));
  const WINDOW_US = 10e6;
  const tmin = Math.max(0, tmax - WINDOW_US);
  const el = document.getElementById("trace");
  const W = el.clientWidth || 760, LH = 30, P = 150, TP = 6;
  const H = TP*2 + tids.length*LH + 16;
  el.setAttribute("viewBox", `0 0 ${W} ${H}`);
  el.style.height = H + "px";
  const sx = us=>P + (W - P - 10) * (us - tmin) / Math.max(tmax - tmin, 1);
  let html = "";
  const seen = new Set();
  tids.forEach((tid, i)=>{
    const y = TP + i*LH;
    html += `<text x="${P-6}" y="${y+LH/2+3}" font-size="10"`+
      ` text-anchor="end">${esc(names[tid] || ("thread-"+tid))}</text>`;
    byTid[tid].forEach(e=>{
      if (e.ts + e.dur < tmin) return;
      seen.add(e.name);
      const x0 = sx(Math.max(e.ts, tmin)), x1 = sx(e.ts + e.dur);
      html += `<rect x="${x0.toFixed(1)}" y="${y+3}"`+
        ` width="${Math.max(x1-x0, 0.8).toFixed(1)}" height="${LH-8}"`+
        ` fill="${spanColor(e.name)}" fill-opacity="0.85">`+
        `<title>${esc(e.name)} ${(e.dur/1000).toFixed(2)} ms</title>`+
        `</rect>`;
    });
  });
  html += `<text x="${P}" y="${H-2}" font-size="10" fill="#888">`+
    `${(tmin/1e6).toFixed(2)}s</text>`+
    `<text x="${W-60}" y="${H-2}" font-size="10" fill="#888">`+
    `${(tmax/1e6).toFixed(2)}s</text>`;
  el.innerHTML = html;
  document.getElementById("tracelegend").innerHTML =
    Array.from(seen).map(n=>`<span style="color:${spanColor(n)}">`+
      `&#9632; ${esc(n)}</span>`).join(" &nbsp;");
}
async function refreshPhases(sess){
  // per-worker training-phase lanes (the Spark timeline tier): the
  // distributed trainers post EventStats as static info "phase_stats";
  // the phase->color map rides in the payload (one canonical source,
  // parallel/stats.py PHASE_COLORS)
  const p = await (await fetch("/api/phases?session="+
                   encodeURIComponent(sess))).json();
  const PHASE_COLORS = p.colors || {};
  const ws = Object.keys(p.workers || {}).sort();
  const card = document.getElementById("phasecard");
  if (!ws.length){ card.style.display = "none"; return; }
  card.style.display = "";
  const el = document.getElementById("phases");
  const W = el.clientWidth || 760, LH = 30, P = 64, TP = 6;
  const H = TP*2 + ws.length*LH + 16;
  el.setAttribute("viewBox", `0 0 ${W} ${H}`);
  el.style.height = H + "px";
  let tmax = 0;
  ws.forEach(w=>p.workers[w].forEach(e=>{
    tmax = Math.max(tmax, e.start + e.duration_ms/1000); }));
  if (tmax <= 0) tmax = 1;
  const sx = t=>P + (W - P - 10) * t / tmax;
  let html = "";
  const seen = new Set();
  ws.forEach((w, i)=>{
    const y = TP + i*LH;
    html += `<text x="${P-6}" y="${y+LH/2+3}" font-size="10"`+
      ` text-anchor="end">${esc(w)}</text>`;
    p.workers[w].forEach(e=>{
      seen.add(e.phase);
      const x0 = sx(e.start), x1 = sx(e.start + e.duration_ms/1000);
      html += `<rect x="${x0.toFixed(1)}" y="${y+3}"`+
        ` width="${Math.max(x1-x0, 1).toFixed(1)}" height="${LH-8}"`+
        ` fill="${PHASE_COLORS[e.phase]||"#7f7f7f"}" fill-opacity="0.85">`+
        `<title>${esc(e.phase)} ${e.duration_ms.toFixed(1)} ms</title>`+
        `</rect>`;
    });
  });
  html += `<text x="${P}" y="${H-2}" font-size="10" fill="#888">0s</text>`+
    `<text x="${W-40}" y="${H-2}" font-size="10" fill="#888">`+
    `${tmax.toFixed(2)}s</text>`;
  el.innerHTML = html;
  document.getElementById("phaselegend").innerHTML =
    Array.from(seen).map(ph=>`<span style="color:${
      PHASE_COLORS[ph]||"#7f7f7f"}">&#9632; ${esc(ph)}</span>`).join(" &nbsp;");
}
let lastModel = null;
function renderHistogram(m){
  if (m) lastModel = m; else m = lastModel;
  if (!m) return;
  const psel = document.getElementById("histparam");
  const kind = document.getElementById("histkind").value;
  // the selector lists the names of the CHOSEN kind (activation stats
  // use layer names, parameter/update stats use parameter paths)
  const stats = kind === "update" ? (m.update_stats||{}) :
    kind === "activation" ? (m.activation_stats||{}) :
    (m.param_stats||{});
  const names = Object.keys(stats);
  const current = Array.from(psel.options).map(o=>o.value);
  if (JSON.stringify(current) !== JSON.stringify(names)){
    const cur = psel.value;
    psel.innerHTML = names.map(n=>`<option>${esc(n)}</option>`).join("");
    if (names.includes(cur)) psel.value = cur;
  }
  const st = stats[psel.value];
  const el = document.getElementById("hist"); el.innerHTML = "";
  if (!st || !st.histogram) return;
  const h = st.histogram, counts = h.counts;
  const W = el.clientWidth || 480, H = el.clientHeight || 220, P = 30;
  const cmax = Math.max(...counts, 1);
  const bw = (W - 2*P) / counts.length;
  let html = `<line x1="${P}" y1="${H-P}" x2="${W-P}" y2="${H-P}"`+
             ` stroke="#bbb"/>`;
  counts.forEach((c, i)=>{
    const bh = (H - 2*P) * c / cmax;
    html += `<rect x="${(P+i*bw).toFixed(1)}" y="${(H-P-bh).toFixed(1)}"`+
      ` width="${Math.max(bw-1,1).toFixed(1)}" height="${bh.toFixed(1)}"`+
      ` fill="#1a73e8"/>`;
  });
  html += `<text x="${P}" y="${H-P+12}" font-size="10" fill="#888">`+
    `${Number(h.min).toPrecision(3)}</text>`+
    `<text x="${W-P-40}" y="${H-P+12}" font-size="10" fill="#888">`+
    `${Number(h.max).toPrecision(3)}</text>`+
    `<text x="${P}" y="${P-6}" font-size="10" fill="#888">max bin `+
    `${cmax}</text>`;
  el.innerHTML = html;
}
document.getElementById("histparam").onchange = ()=>renderHistogram();
document.getElementById("histkind").onchange = ()=>renderHistogram();
let flowCache = null;
async function refreshFlow(sess, actStats){
  // topology is static per session: fetch once (but keep re-fetching
  // while null — the model info may be posted after the first poll)
  if (flowCache !== sess || !window._flowModel){
    const f = await (await fetch("/api/flow?session="+
                     encodeURIComponent(sess))).json();
    flowCache = sess;
    window._flowModel = f.model;
  }
  const model = window._flowModel;
  const card = document.getElementById("flowcard");
  if (!model || !model.layers || !model.layers.length){
    card.style.display = "none"; return;
  }
  card.style.display = "";
  const el = document.getElementById("flow");
  const BW = 190, BH = 34, GAP = 14, P = 10;
  const layers = model.layers;
  const H = P*2 + layers.length*(BH+GAP);
  el.setAttribute("viewBox", `0 0 420 ${H}`);
  el.style.height = Math.min(H, 600) + "px";
  const ypos = {};
  layers.forEach((l, i)=>{ ypos[l.name] = P + i*(BH+GAP); });
  // color boxes by activation mean |a| when the probe publishes it
  const mags = {};
  let mmax = 0;
  for (const [k, v] of Object.entries(actStats || {})){
    mags[k] = v.mean_magnitude; mmax = Math.max(mmax, v.mean_magnitude);
  }
  let html = "";
  layers.forEach((l)=>{
    const y = ypos[l.name];
    (l.inputs||[]).forEach(src=>{
      if (src in ypos)
        html += `<line x1="${P+BW/2}" y1="${ypos[src]+BH}"`+
          ` x2="${P+BW/2}" y2="${y}" stroke="#999"`+
          ` marker-end="none"/>`;
    });
    const m = mags[l.name];
    const shade = (m != null && mmax > 0) ?
      Math.round(235 - 140*(m/mmax)) : 235;
    html += `<rect x="${P}" y="${y}" width="${BW}" height="${BH}" rx="5"`+
      ` fill="rgb(${shade},${shade},255)" stroke="#1a237e"/>`+
      `<text x="${P+8}" y="${y+14}" font-size="11" font-weight="600">`+
      `${esc(l.name)}</text>`+
      `<text x="${P+8}" y="${y+27}" font-size="10" fill="#555">`+
      `${esc(l.type)} · ${l.params.toLocaleString()} params`+
      `${m != null ? " · |a| "+Number(m).toPrecision(3) : ""}</text>`;
  });
  el.innerHTML = html;
}
let embCache = {sess: null, version: null};
async function refreshEmbedding(sess, version){
  // fetch + rebuild the scatter only when a (re)published embedding's
  // version changes — /api/model carries the version on every poll
  if (embCache.sess === sess && embCache.version === version) return;
  embCache = {sess: sess, version: version};
  const card = document.getElementById("embcard");
  if (version == null){ card.style.display = "none"; return; }
  const e = await (await fetch("/api/embedding?session="+
                   encodeURIComponent(sess))).json();
  if (!e.xy || e.xy.length === 0){ card.style.display = "none"; return; }
  card.style.display = "";
  const el = document.getElementById("emb"); el.innerHTML = "";
  const W = el.clientWidth || 480, H = el.clientHeight || 320, P = 20;
  const xs = e.xy.map(p=>p[0]), ys = e.xy.map(p=>p[1]);
  const xmin=Math.min(...xs), xmax=Math.max(...xs);
  const ymin=Math.min(...ys), ymax=Math.max(...ys);
  const sx=x=>P+(W-2*P)*(x-xmin)/Math.max(xmax-xmin,1e-9);
  const sy=y=>H-P-(H-2*P)*(y-ymin)/Math.max(ymax-ymin,1e-9);
  let html = "";
  e.xy.forEach((p, i)=>{
    const c = COLORS[i % COLORS.length];
    html += `<circle cx="${sx(p[0]).toFixed(1)}" cy="${sy(p[1]).toFixed(1)}"`+
      ` r="2.5" fill="${c}"/>`;
    if (e.labels[i]) html += `<text x="${(sx(p[0])+4).toFixed(1)}"`+
      ` y="${(sy(p[1])+3).toFixed(1)}" font-size="9" fill="#555">`+
      `${esc(e.labels[i])}</text>`;
  });
  el.innerHTML = html;
}
async function init(){
  const s = await (await fetch("/api/sessions")).json();
  const sel = document.getElementById("session");
  sel.innerHTML = s.sessions.map(x=>`<option>${esc(x)}</option>`).join("");
  sel.onchange = refresh;
  await refresh();
  setInterval(refresh, 2000);
}
init();
</script></body></html>"""


class _Handler(BaseHTTPRequestHandler):
    server_version = "dl4j-tpu-ui/1.0"

    def log_message(self, *args):  # quiet
        pass

    def _send(self, body: bytes, ctype: str, code: int = 200) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _json(self, obj, code: int = 200) -> None:
        self._send(json.dumps(obj).encode(), "application/json", code)

    def do_GET(self):  # noqa: N802 (stdlib API)
        ui: "UIServer" = self.server.ui_server  # type: ignore[attr-defined]
        url = urlparse(self.path)
        q = {k: v[0] for k, v in parse_qs(url.query).items()}
        if url.path == "/":
            self._send(_PAGE.encode(), "text/html; charset=utf-8")
        elif url.path == "/api/sessions":
            self._json(ui.sessions_payload())
        elif url.path == "/api/updates":
            sess = q.get("session", "")
            after = float(q.get("after", "-inf"))
            self._json(ui.updates_payload(sess, after))
        elif url.path == "/api/model":
            self._json(ui.model_payload(q.get("session", "")))
        elif url.path == "/api/embedding":
            self._json(ui.embedding_payload(q.get("session", "")))
        elif url.path == "/api/flow":
            self._json(ui.flow_payload(q.get("session", "")))
        elif url.path == "/api/phases":
            self._json(ui.phases_payload(q.get("session", "")))
        elif url.path == "/metrics":
            from deeplearning4j_tpu_torch.observability import metrics as om
            if "format=snapshot" in url.query:
                from deeplearning4j_tpu_torch.observability import (
                    distributed as dist)
                self._json(dist.export_snapshot())
            elif om.wants_prometheus(self.headers.get("Accept", ""),
                                     url.query):
                if ui.federation.instance_count():
                    # fleet members have pushed: render the merged view
                    # (this process folded in as one more instance)
                    from deeplearning4j_tpu_torch.observability import (
                        distributed as dist)
                    body = ui.federation.render_prometheus(
                        local=(dist.get_identity().tag,
                               om.get_registry().collect()))
                else:
                    body = om.get_registry().render_prometheus()
                self._send(body.encode(), om.PROMETHEUS_CONTENT_TYPE)
            else:
                self._json(om.get_registry().snapshot())
        elif url.path == "/api/fleet":
            self._json(ui.federation.fleet_payload())
        elif url.path == "/api/traces":
            self._json({"traces": ui.trace_store.trace_ids(),
                        "store": ui.trace_store.describe()})
        elif url.path.startswith("/api/trace/"):
            tid = url.path[len("/api/trace/"):].strip("/")
            wf = ui.trace_store.waterfall(tid)
            self._json(wf, 200 if wf.get("found") else 404)
        elif url.path == "/api/trace":
            from deeplearning4j_tpu_torch.observability.trace import get_tracer
            self._json(get_tracer().to_chrome_trace())
        elif url.path == "/api/goodput":
            from deeplearning4j_tpu_torch.observability import goodput
            self._json(goodput.live_snapshot())
        else:
            self._json({"error": "not found"}, 404)

    def do_POST(self):  # noqa: N802 (stdlib API)
        # remote stats receiver (the reference UI's remote module:
        # workers post through a StatsStorageRouter — ui/router.py) plus
        # the metrics-federation push endpoint
        ui: "UIServer" = self.server.ui_server  # type: ignore[attr-defined]
        path = urlparse(self.path).path
        if path not in ("/api/post", "/api/metrics_push"):
            self._json({"error": "not found"}, 404)
            return
        try:
            n = int(self.headers.get("Content-Length", 0))
            payload = json.loads(self.rfile.read(n).decode())
            if path == "/api/metrics_push":
                tag = ui.federation.ingest(payload)
                # same push, second consumer: any request-scoped span
                # batch riding the snapshot lands in the trace store
                ui.trace_store.ingest_snapshot(payload)
                self._json({"status": "ok", "instance": tag,
                            "instances": ui.federation.instance_count()})
            else:
                ui.receive_post(payload)
                self._json({"status": "ok"})
        except Exception as e:  # malformed post must not kill the server
            self._json({"error": f"{type(e).__name__}: {e}"}, 400)


class UIServer:
    """Singleton dashboard server over attached StatsStorage instances."""

    _instance: Optional["UIServer"] = None

    def __init__(self, port: int = 9000, host: str = "127.0.0.1"):
        self.storages: List[BaseStatsStorage] = []
        self._remote_storage: Optional[BaseStatsStorage] = None
        self._remote_lock = threading.Lock()
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.ui_server = self  # type: ignore[attr-defined]
        # /metrics serves the unified registry — make sure the runtime
        # collector (compile count, device memory, steps/sec) is on it
        from deeplearning4j_tpu_torch.observability.metrics import (
            install_runtime_metrics)
        install_runtime_metrics()
        # fleet aggregator: child processes push export_snapshot() to
        # /api/metrics_push; /metrics re-exports the merged view and
        # /api/fleet serves the health scoreboard
        from deeplearning4j_tpu_torch.observability.distributed import (
            MetricsFederation, TraceStore)
        self.federation = MetricsFederation()
        # request-scoped span index: span batches riding the same
        # /api/metrics_push wire land here; /api/trace/<id> serves the
        # stitched waterfall the dashboard panel renders
        self.trace_store = TraceStore()
        self.port = self._httpd.server_address[1]  # resolved if port=0
        self.host = host
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="dl4j-tpu-ui-server")
        self._thread.start()

    # PlayUIServer.getInstance() parity
    @classmethod
    def get_instance(cls, port: int = 9000,
                     host: str = "127.0.0.1") -> "UIServer":
        if cls._instance is None:
            cls._instance = cls(port=port, host=host)
        return cls._instance

    def attach(self, storage: BaseStatsStorage) -> None:
        if storage not in self.storages:
            self.storages.append(storage)

    def receive_post(self, payload: dict) -> None:
        """Store a remotely-posted report (lazily creating the receiving
        storage on first post — the reference's remote-module role)."""
        from deeplearning4j_tpu_torch.ui.stats import StatsReport
        from deeplearning4j_tpu_torch.ui.storage import InMemoryStatsStorage
        with self._remote_lock:
            # handler threads race the first post: exactly ONE receiving
            # storage may ever be attached or early reports strand in an
            # orphan the dashboard resolves first
            if self._remote_storage is None:
                self._remote_storage = InMemoryStatsStorage()
                self.attach(self._remote_storage)
        kind = payload.get("type")
        if kind == "update":
            self._remote_storage.put_update(
                StatsReport.from_dict(payload["report"]))
        elif kind == "static_info":
            self._remote_storage.put_static_info(
                payload["session_id"], payload["worker_id"],
                payload["info"])
        else:
            raise ValueError(f"unknown post type {kind!r}")

    def detach(self, storage: BaseStatsStorage) -> None:
        self.storages = [s for s in self.storages if s is not storage]

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}/"

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)
        if UIServer._instance is self:
            UIServer._instance = None

    # ------------------------------------------------------ JSON payloads
    def _find(self, session_id: str) -> Optional[BaseStatsStorage]:
        for s in self.storages:
            if session_id in s.list_session_ids():
                return s
        return None

    def sessions_payload(self) -> dict:
        sessions = []
        for s in self.storages:
            sessions.extend(s.list_session_ids())
        return {"sessions": sorted(set(sessions))}

    def updates_payload(self, session_id: str, after: float) -> dict:
        storage = self._find(session_id)
        if storage is None:
            return {"iterations": [], "scores": [], "iteration_ms": [],
                    "examples_per_sec": [], "latest": None}
        reports = storage.get_all_updates_after(session_id, after)
        latest = reports[-1].to_dict() if reports else None
        if latest:
            latest.pop("param_stats", None)
            latest.pop("update_stats", None)
            latest.pop("activation_stats", None)
        # per-worker series: a multi-process (DP-2) run posts through the
        # remote router and every worker renders as its own curve
        workers: dict = {}
        for r in reports:
            w = workers.setdefault(r.worker_id, {"iterations": [],
                                                 "scores": [],
                                                 "iteration_ms": []})
            w["iterations"].append(r.iteration)
            w["scores"].append(r.score)
            w["iteration_ms"].append(r.iteration_ms)
        return {
            "iterations": [r.iteration for r in reports],
            "scores": [r.score for r in reports],
            "iteration_ms": [r.iteration_ms for r in reports],
            "examples_per_sec": [r.examples_per_sec for r in reports],
            "workers": workers,
            "latest": latest,
        }

    def flow_payload(self, session_id: str) -> dict:
        """Model topology for the flow view (the reference UI's
        flow/model tabs): first worker's posted static model info."""
        for s in self.storages:
            for wid in s.list_worker_ids_for_session(session_id):
                info = s.get_static_info(session_id, wid)
                if info and "model" in info:
                    return {"model": info["model"], "worker": wid}
        return {"model": None, "worker": None}

    def phases_payload(self, session_id: str) -> dict:
        """Per-worker phase EventStats for the timeline card (the Spark
        timeline surface — ParameterAveragingTrainingMasterStats /
        StatsUtils.exportStatsAsHtml; the distributed trainers post
        ``phase_stats`` via TrainingStatsCollector.post_to)."""
        workers = {}
        for s in self.storages:
            for wid in s.list_worker_ids_for_session(session_id):
                info = s.get_static_info(session_id, wid)
                if info and "phase_stats" in info:
                    workers[wid] = info["phase_stats"]
        # colors ride in the payload so the live dashboard and the
        # exported timeline HTML stay on ONE canonical phase->color map
        return {"workers": workers, "colors": PHASE_COLORS}

    def embedding_payload(self, session_id: str) -> dict:
        """Published 2-D embedding scatter for the session (the reference
        UI's tsne tab — ui/embedding.py publishes it)."""
        from deeplearning4j_tpu_torch.ui.embedding import get_embedding
        info = get_embedding(self.storages, session_id)
        return info or {"labels": [], "xy": []}

    def model_payload(self, session_id: str) -> dict:
        storage = self._find(session_id)
        latest = storage.get_latest_update(session_id) if storage else None
        from deeplearning4j_tpu_torch.ui.embedding import get_embedding
        emb = get_embedding(self.storages, session_id) or {}
        if latest is None:
            return {"param_stats": {}, "update_stats": {},
                    "activation_stats": {},
                    "embedding_version": emb.get("version")}
        return {"param_stats": latest.param_stats,
                "update_stats": latest.update_stats,
                "activation_stats": getattr(latest, "activation_stats", {}),
                # lets the page detect a (re)published embedding without
                # downloading the full scatter every poll
                "embedding_version": emb.get("version")}
