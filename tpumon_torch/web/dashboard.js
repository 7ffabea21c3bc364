/* dashboard.js — ALL dashboard behavior: fetch handling, SSE frames,
 * card/chip/pod/alert/serving rendering, history windows, chip modal.
 *
 * Like chartcore.js this file is written in the jsmini dialect (see
 * tests/jsmini.py: no classes/this/new/async/try/regex/switch) so CI
 * EXECUTES the exact file the browser loads (tests/test_dashboard_js.py)
 * — a thrown TypeError anywhere in here fails the suite (VERDICT r02
 * item #3; the r01/r02 version of this logic lived as an inline
 * <script> that was only regex-checked).
 *
 * Browser specifics are injected (the inline bootstrap in
 * dashboard.html provides them; tests provide fakes):
 *   doc  { el(id), mk(tag), queryAll(sel) }        DOM access
 *   net  { getJson(url, cb), postJson(url, body, done) }   cb(null) on error
 *   env  { nowMs(), timeStr(), localeTime(ms), winWidth() }
 *   mkSurface(canvasEl) -> { geom(), ctx() }       canvas sizing + 2D ctx
 *
 * Element contract used here (browser DOM satisfies it; the test fake
 * implements exactly this): textContent, innerHTML, title, className,
 * colSpan, dataset, style.<prop>, classList.{add,remove,toggle,
 * contains}, appendChild, append(...), replaceChildren(), onclick.
 */
"use strict";

/* ------------------------------ line chart ----------------------------- */
/* Chart instance over an injected surface; all geometry/drawing comes
   from chartcore.js (chartDraw/chartTipIndex/chartTipRows). */
function makeLineChart(surface, series, opts) {
  let labels = [];
  let data = series.map(() => []);
  let lastGeom = null;

  const draw = () => {
    const g = surface.geom();
    const res = chartDraw(surface.ctx(), g, labels, data, series, opts);
    lastGeom = { g: g, n: res.n };
  };
  /* update(labels, datasets[]): datasets is an ARRAY of series arrays
     (the old inline engine took varargs; the dialect has no rest args) */
  const update = (newLabels, datasets) => {
    labels = newLabels || [];
    (datasets || []).forEach((d, i) => { data[i] = (d || []).map(Number); });
    draw();
  };
  /* hover px -> {label, rows} (tooltip content) or null */
  const tipAt = px => {
    if (!lastGeom || !labels.length) return null;
    const i = chartTipIndex(px, lastGeom.g, lastGeom.n);
    if (i < 0) return null;
    return { label: labels[i], rows: chartTipRows(series, data, i, opts) };
  };
  return { draw: draw, update: update, tipAt: tipAt };
}

/* --------------------------- delta SSE codec --------------------------- */
/* Mirror of tpumon/deltas.py apply_delta — the server diffs successive
   realtime payloads into patch nodes ({"s": replace}, {"o": object
   merge, "d": dropped keys}, {"l": [[index, node]] list patches}) and
   the stream carries only what moved. One deviation forced by the
   dialect (no `delete`): dropped keys are set to undefined instead of
   removed — invisible to every renderer here (all reads are ?.-guarded)
   and to Object.keys consumers of the realtime payload (none). */
function applyDelta(target, node) {
  if (node == null) return target;
  if (node.s !== undefined) return node.s;
  if (node.l !== undefined) {
    for (const p of node.l) target[p[0]] = applyDelta(target[p[0]], p[1]);
    return target;
  }
  if (node.o !== undefined) {
    for (const k of Object.keys(node.o))
      target[k] = applyDelta(target[k], node.o[k]);
  }
  if (node.d !== undefined) {
    for (const k of node.d) target[k] = undefined;
  }
  return target;
}

/* Accelerator-family display terms: JSON keys stay the
   TPU-native names (mxu_duty_pct, hbm_*, ici_*) for every payload
   contract; anything the USER reads renders the chip's own family
   vocabulary. Mirror of tpumon.topology.accel_terms. */
function accelTerms(accelKind) {
  return accelKind === "gpu"
    ? { duty: "SM", mem: "VRAM", link: "NVLink" }
    : { duty: "MXU", mem: "HBM", link: "ICI" };
}

/* ------------------------------ dashboard ------------------------------ */

function makeDashboard(doc, net, env, mkSurface) {
  const $ = id => doc.el(id);

  /* ---- charts (ids match dashboard.html canvases) ---- */
  const mkChart = (cid, series, opts) => {
    const c = makeLineChart(mkSurface($(cid)), series, opts);
    c.canvasId = cid;
    return c;
  };
  const charts = {
    cpu:  mkChart("c-cpu",  [{label:"CPU %",  color:"#3b82f6", fill:true}], {yMax:100, unit:"%"}),
    mem:  mkChart("c-mem",  [{label:"Memory %", color:"#a78bfa", fill:true}], {yMax:100, unit:"%"}),
    disk: mkChart("c-disk", [{label:"Disk %", color:"#fbbf24", fill:true}], {yMax:100, unit:"%"}),
    tpu:  mkChart("c-tpu",  [{label:"MXU duty %", color:"#36d399", fill:true},
                             {label:"HBM %", color:"#22d3ee"}], {yMax:100, unit:"%"}),
    temp: mkChart("c-temp", [{label:"°C", color:"#fb923c", fill:true}], {yMax:110}),
    ici:  mkChart("c-ici",  [{label:"ICI tx", color:"#f472b6", fill:true},
                             {label:"DCN tx (NIC)", color:"#60a5fa"}], {unit:"bps"}),
    serving: mkChart("c-serving", [{label:"tokens/s", color:"#36d399", fill:true},
                                   {label:"TTFT p50 ms", color:"#fbbf24"}], {}),
    servingHealth: mkChart("c-serving-health",
      [{label:"spec accept %", color:"#22d3ee"},
       {label:"prefix hit %", color:"#36d399"},
       {label:"KV pool %", color:"#a78bfa", fill:true}], {yMax:100, unit:"%"}),
    tpuHealth: mkChart("c-tpu-health",
      [{label:"worst ICI link score", color:"#f59e0b", fill:true},
       {label:"worst throttle score", color:"#f87171"}], {yMax:10}),
    train: mkChart("c-train", [{label:"loss", color:"#f472b6", fill:true},
                               {label:"tokens/s", color:"#36d399"}], {}),
  };

  /* ---- state ---- */
  let histWindow = "30m";
  let lastHistory = null;   // latest /api/history payload
  let currentChipId = null; // chip shown in the open drill-down modal
  let currentAlerts = { minor: [], serious: [], critical: [] };
  let topoHit = [];         // [{x, y, r, chip}] css px, for hover/click
  let chipChart = null;

  /* ------------------------------ cards ------------------------------ */
  function setCard(prefix, pct, sub) {
    $(prefix + "-v").textContent = fmtPct(pct);
    if (sub != null) $(prefix + "-s").textContent = sub;
    const bar = $(prefix + "-b");
    bar.style.width = (pct == null ? 0 : Math.min(100, pct)) + "%";
    bar.className = pct > 95 ? "bad" : pct > 85 ? "warn" : "";
  }

  function applyHost(host) {
    if (!host) return;
    setCard("cpu", host.cpu?.percent,
            `load ${host.cpu?.load_1min ?? "–"} · ${host.cpu?.cores ?? "?"} cores`);
    setCard("mem", host.memory?.percent,
            `${fmtGiB(host.memory?.used)} / ${fmtGiB(host.memory?.total)}`);
    setCard("disk", host.disk?.percent,
            `${fmtGiB(host.disk?.used)} / ${fmtGiB(host.disk?.total)}`);
    // Live NIC rates — the cross-host DCN-traffic proxy (the chart
    // plots the same series historically; this is the current tick).
    const nr = host.net_rates;
    $("dcn-tag").textContent = nr && nr.tx_bps != null
      ? `now ↑ ${fmtBps(nr.tx_bps)} · ↓ ${fmtBps(nr.rx_bps)}` : "";
  }

  /* --------------------------- chips & topo --------------------------- */
  const mkRow = (a, b) => {
    const r = doc.mk("div"); r.className = "row";
    const l = doc.mk("span"); l.textContent = a;
    const v = doc.mk("span"); v.textContent = b;
    r.append(l, v); return r;
  };

  function renderChips(accel) {
    renderTopo(accel);
    const grid = $("chips");
    const chips = accel?.chips || [];
    const meanDuty = meanOf(chips.map(c => c.mxu_duty_pct));
    // Mixed fleets list every kind present ("v5p+a100"), so the card
    // says what the mean is a mean OF.
    const kinds = uniqSorted(chips.map(c => c.kind)).join("+");
    setCard("mxu", meanDuty,
            chips.length ? `${chips.length} chip(s) · ${kinds}` : "no chips");
    const slices = accel?.slices || [];
    $("topo-tag").textContent = chips.length
      ? `${chips.length} chips · ${slices.length} slice(s)` : "no chips";
    grid.replaceChildren();
    if (!chips.length) {
      const div = doc.mk("div");
      div.className = "empty";
      div.textContent = accel?.health?.error || "no accelerator source";
      grid.appendChild(div);
      return;
    }
    for (const c of chips) {
      const t = accelTerms(c.accel_kind);
      const el = doc.mk("div");
      el.className = "chip";
      el.style.cursor = "pointer";
      el.title = "click for history" +
        (c.counter_source ? ` · counters: ${c.counter_source}` : "");
      el.onclick = () => openChipModal(c.chip);
      const cid = doc.mk("div"); cid.className = "cid";
      cid.textContent = c.chip; cid.title = c.chip; el.appendChild(cid);
      const duty = doc.mk("div"); duty.className = "duty";
      duty.innerHTML = (c.mxu_duty_pct == null ? "–" : c.mxu_duty_pct.toFixed(1)) +
        `<small> % ${t.duty}</small>`;
      el.appendChild(duty);
      const bar = doc.mk("div"); bar.className = "bar";
      const fill = doc.mk("i");
      const hbmPct = c.hbm_pct;
      fill.style.width = (hbmPct ?? 0) + "%";
      if (hbmPct > 95) fill.className = "bad";
      else if (hbmPct > 85) fill.className = "warn";
      bar.appendChild(fill); el.appendChild(bar);
      el.appendChild(mkRow(t.mem, hbmPct == null ? "–" :
        `${fmtGiB(c.hbm_used)} (${hbmPct.toFixed(0)}%)`));
      el.appendChild(mkRow("temp", c.temp_c == null ? "–" : c.temp_c.toFixed(0) + "°C"));
      el.appendChild(mkRow(`${t.link} tx`, fmtBps(c.tx_bps)));
      // libtpu SDK scores (0-10), rendered only when degraded/throttled.
      if (c.ici_link_health != null && c.ici_link_health > 0)
        el.appendChild(mkRow(`${t.link} health`, c.ici_link_health + "/10"));
      if (c.throttle_score != null && c.throttle_score > 0)
        el.appendChild(mkRow("throttle", "~" + (c.throttle_score * 10) + "%"));
      if (c.pod) {
        const parts = c.pod.split("/");
        el.appendChild(mkRow("pod", parts[parts.length - 1]));
      }
      grid.appendChild(el);
    }
  }

  /* Topology card: layout/colors/edges live in chartcore.js topoDraw;
     this owns card visibility and the hit targets. */
  let topoSurface = null;
  function renderTopo(accel) {
    const card = $("topo-card");
    const chips = accel?.chips || [];
    if (chips.length < 2) { card.style.display = "none"; topoHit = []; return; }
    card.style.display = "";
    const slices = uniqSorted(chips.map(c => c.slice));
    $("topo-map-tag").textContent = slices.length > 1
      ? `${slices.length} slices` : (slices[0] || "");
    if (!topoSurface) topoSurface = mkSurface($("c-topo"));
    const g = topoSurface.geom();
    const ctx = topoSurface.ctx();
    ctx.clearRect(0, 0, g.w, g.h);
    topoHit = topoDraw(ctx, chips, g.w, g.h);
  }

  const hitAt = (mx, my) => {
    for (const p of topoHit) {
      if ((p.x - mx) ** 2 + (p.y - my) ** 2 <= p.r * p.r) return p;
    }
    return null;
  };
  /* topo hover -> {title, lines[]} for the tooltip, or null */
  function topoTipAt(mx, my) {
    const hit = hitAt(mx, my);
    if (!hit) return null;
    const c = hit.chip;
    const t = accelTerms(c.accel_kind);
    return {
      title: c.chip,
      lines: [
        `${t.duty}: ${c.mxu_duty_pct == null ? "–" : c.mxu_duty_pct.toFixed(1) + "%"}`,
        `${t.mem}: ${c.hbm_pct == null ? "–" : c.hbm_pct.toFixed(0) + "%"}`,
        `${t.link} tx: ${fmtBps(c.tx_bps)}`, `${t.link} rx: ${fmtBps(c.rx_bps)}`,
        `host: ${c.host}`, `pod: ${c.pod ?? "–"}`,
      ],
    };
  }
  function topoClickAt(mx, my) {
    const hit = hitAt(mx, my);
    if (hit) openChipModal(hit.chip.chip);
  }

  /* ----------------------------- self-trace ---------------------------- */
  /* Per-tick stage timeline (tpumon/tracing.py last_tick, delivered in
     the SSE realtime payload): one proportional segment per stage —
     collect.host, collect.accel, history, alerts — so "where did this
     tick's milliseconds go" is answered at a glance. Stage colors are
     assigned by first-seen order and stay stable across ticks. */
  const traceColors = ["#3b82f6", "#36d399", "#fbbf24", "#a78bfa",
                       "#22d3ee", "#f472b6", "#fb923c", "#f87171"];
  const traceColorByStage = {};
  let traceColorsUsed = 0;
  function traceColor(name) {
    if (traceColorByStage[name] === undefined) {
      traceColorByStage[name] = traceColors[traceColorsUsed % traceColors.length];
      traceColorsUsed += 1;
    }
    return traceColorByStage[name];
  }

  function renderTrace(tr) {
    const card = $("trace-card");
    const stages = tr?.stages || [];
    if (!stages.length) { card.style.display = "none"; return; }
    card.style.display = "";
    $("trace-tag").textContent = `tick ${(tr.total_ms ?? 0).toFixed(1)} ms`;
    const strip = $("trace-strip");
    const legend = $("trace-legend");
    strip.replaceChildren();
    legend.replaceChildren();
    let total = 0;
    for (const s of stages) total += s.ms;
    for (const s of stages) {
      const seg = doc.mk("i");
      seg.style.width = (total > 0 ? (100 * s.ms / total) : 0) + "%";
      seg.style.background = traceColor(s.name);
      seg.title = `${s.name} · ${s.ms.toFixed(2)} ms`;
      strip.appendChild(seg);
      const lab = doc.mk("span");
      const dot = doc.mk("i");
      dot.style.background = traceColor(s.name);
      const txt = doc.mk("span");
      txt.textContent = `${s.name} ${s.ms.toFixed(2)} ms`;
      lab.append(dot, txt);
      legend.appendChild(lab);
    }
  }

  /* Fleet freshness waterfall (the federation tree): one
     bar per origin node on the trace card — how long that node's
     newest sample took to become visible HERE, clock-offset
     corrected. Bars share one scale (the slowest node spans the
     track); fed from the /api/federation payload's freshness block,
     so it costs no extra fetch loop. */
  function renderFleetWaterfall(fresh) {
    const box = $("fleet-waterfall");
    if (!box) return;
    const names = fresh ? Object.keys(fresh).sort() : [];
    if (!names.length) { box.style.display = "none"; return; }
    box.style.display = "";
    box.replaceChildren();
    const head = doc.mk("div");
    head.textContent = "fleet freshness · leaf sample → visible here";
    box.appendChild(head);
    let max = 0;
    for (const n of names) max = Math.max(max, fresh[n].ms || 0);
    for (const n of names) {
      const ms = fresh[n].ms || 0;
      const row = doc.mk("div"); row.className = "fw-row";
      const lab = doc.mk("span"); lab.className = "fw-node";
      lab.textContent = n;
      lab.title = `via ${fresh[n].via || "?"} · offset ` +
        `${(fresh[n].offset_ms ?? 0).toFixed(1)} ms`;
      const track = doc.mk("span"); track.className = "fw-track";
      const bar = doc.mk("i"); bar.className = "fw-bar";
      bar.style.width =
        (max > 0 ? Math.max(2, 100 * ms / max) : 0) + "%";
      track.appendChild(bar);
      const val = doc.mk("span"); val.className = "fw-ms";
      val.textContent = ms.toFixed(0) + " ms";
      row.append(lab, track, val);
      box.appendChild(row);
    }
  }

  /* Polling fallback for the strip: when the SSE stream is down the
     rest of the page refreshes via fetch loops — the trace card must
     not freeze on the last streamed tick. /api/trace rides the epoch
     render cache server-side, so this poll is cached bytes. */
  function fetchTrace() {
    net.getJson("/api/trace", t => { if (t) renderTrace(t.last_tick); });
  }

  /* ---------------------------- event feed ---------------------------- */
  /* Live journal tail (tpumon/events.py): the SSE payload carries the
     last 20 events ({seq, recent}), newest first; /api/events is the
     polling fallback. A severity filter narrows the feed client-side
     (the full window is already on hand — no refetch per click). */
  let eventFilter = "all";
  let lastEvents = null;  // latest {seq, recent} view rendered

  function renderEvents(ev) {
    const card = $("events-card");
    const recent = ev?.recent || [];
    if (!recent.length) { card.style.display = "none"; return; }
    lastEvents = ev;
    card.style.display = "";
    $("events-tag").textContent = `seq ${ev.seq ?? "?"}`;
    const feed = $("events-feed");
    feed.replaceChildren();
    const shown = recent.filter(
      e => eventFilter === "all" || e.severity === eventFilter);
    if (!shown.length) {
      const empty = doc.mk("div");
      empty.className = "event-line";
      empty.textContent = `no recent ${eventFilter} events`;
      feed.appendChild(empty);
      return;
    }
    for (const e of shown) {
      const row = doc.mk("div");
      row.className = "event-line sev-" + (e.severity || "info");
      const when = doc.mk("span");
      when.className = "ev-t";
      when.textContent = env.localeTime((e.ts || 0) * 1000);
      const kind = doc.mk("span");
      kind.className = "ev-k";
      kind.textContent = e.kind || "?";
      const msg = doc.mk("span");
      msg.className = "ev-m";
      msg.textContent =
        (e.source ? e.source + " · " : "") + (e.msg ?? e.title ?? "");
      row.append(when, kind, msg);
      feed.appendChild(row);
    }
  }

  function setEventFilter(sev) {
    eventFilter = sev;
    for (const b of doc.queryAll(".evbtn"))
      b.classList.toggle("on", b.dataset.sev === sev);
    if (lastEvents) renderEvents(lastEvents);
  }

  function fetchEvents() {
    net.getJson("/api/events?limit=20", d => {
      if (!d) return;
      // /api/events pages ascending; the feed wants newest first.
      renderEvents({ seq: d.seq, recent: (d.events || []).slice().reverse() });
    });
  }

  /* ------------------------------ realtime ---------------------------- */
  function fetchRealtime() {
    net.getJson("/api/host/metrics", host => {
      net.getJson("/api/accel/metrics", accel => {
        applyHost(host);
        renderChips(accel);
      });
    });
  }

  /* Live push: delta frames keyed by snapshot epoch (tpumon/server.py
     _stream docstring has the 3-frame protocol). The bootstrap passes
     each JSON-parsed frame here; "resync" tells it to reconnect (a
     fresh connection's first frame is always a keyframe). State: the
     last full payload, patched in place by delta frames. */
  let streamEpoch = -1;
  let streamData = null;

  function renderStream() {
    if (!streamData) return;
    applyHost(streamData.host);
    renderChips(streamData.accel);
    renderTrace(streamData.trace);
    renderEvents(streamData.events);
    renderActuate(streamData.actuate);
    const al = streamData.alerts;
    if (al) {
      $("n-minor").textContent = al.minor ?? 0;
      $("n-serious").textContent = al.serious ?? 0;
      $("n-critical").textContent = al.critical ?? 0;
      $("crit-badge").classList.toggle("active", (al.critical ?? 0) > 0);
    }
  }

  function onStreamFrame(d) {
    if (!d) return "ok";  // malformed frames dropped upstream
    if (d.key !== undefined) {  // keyframe: replace state wholesale
      streamData = d.key;
      streamEpoch = d.epoch;
      renderStream();
      return "ok";
    }
    if (d.prev !== undefined) {  // delta or heartbeat
      if (d.prev !== streamEpoch || streamData === null) {
        // Gap: this patch applies to a payload we don't hold (missed
        // frame, server restart). Drop state and ask for a resync.
        streamEpoch = -1;
        streamData = null;
        return "resync";
      }
      streamEpoch = d.epoch;
      if (d.patch == null) return "ok";  // heartbeat: nothing moved
      streamData = applyDelta(streamData, d.patch);
      renderStream();
      return "ok";
    }
    // Legacy full frame (pre-delta wire): render it directly.
    streamData = d;
    streamEpoch = -1;
    renderStream();
    return "ok";
  }

  /* ------------------------------ history ------------------------------ */
  const WIN_LABELS = { "30m": "30 min", "3h": "3 h", "12h": "12 h", "24h": "24 h" };
  function setWindow(w) {
    histWindow = w;
    for (const b of doc.queryAll(".winbtn"))
      b.classList.toggle("on", b.dataset.w === w);
    for (const e of doc.queryAll(".hwin"))
      e.textContent = WIN_LABELS[w] || w;
    fetchHistory();
  }

  function applyHistory(h, win) {
    // Discard responses from a window the user has since switched away
    // from — a slow 24h fetch must not repaint the 30m view.
    if (!h || win !== histWindow) return;
    lastHistory = h;
    // Keep an open chip drill-down live (its empty state promises that
    // samples accumulate — so re-render it as they do). A fresh fleet
    // payload re-arms the per-chip series= fallback fetch too.
    chipSeriesFetched = null;
    if (currentChipId !== null) openChipModal(currentChipId);
    charts.cpu.update(h.cpu?.labels, [h.cpu?.data]);
    charts.mem.update(h.memory?.labels, [h.memory?.data]);
    charts.disk.update(h.disk?.labels, [h.disk?.data]);
    charts.tpu.update(h.mxu?.labels?.length ? h.mxu.labels : h.hbm?.labels,
                      [h.mxu?.data, h.hbm?.data]);
    charts.temp.update(h.temp?.labels, [h.temp?.data]);
    charts.ici.update(h.ici?.labels?.length ? h.ici.labels : h.dcn?.labels,
                      [h.ici?.data, h.dcn?.data]);
    // Optional multi-series charts: card shows when any series has
    // data; labels come from whichever series has them.
    const optionalChart = (cardId, chart, list) => {
      const has = list.some(s => s?.data?.length);
      $(cardId).style.display = has ? "" : "none";
      if (!has) return;
      const lab = list.find(s => s?.labels?.length);
      chart.update(lab ? lab.labels : [], list.map(s => s?.data));
    };
    optionalChart("tpu-health-card", charts.tpuHealth,
                  [h.ici_health_max, h.throttle_max]);
    optionalChart("serving-chart-card", charts.serving,
                  [h.tokens_per_sec, h.ttft_p50_ms]);
    optionalChart("serving-health-card", charts.servingHealth,
                  [h.spec_accept_pct, h.prefix_hit_pct, h.kv_pool_pct]);
    optionalChart("train-chart-card", charts.train,
                  [h.train_loss, h.train_tokens_per_sec]);
  }

  function fetchHistory() {
    const win = histWindow;
    net.getJson("/api/history?window=" + win, h => applyHistory(h, win));
  }

  /* ------------------------ per-chip drill-down ------------------------ */
  /* The server records chip.<id>.mxu/.hbm/.temp/.link ring series and
     ships them as /api/history per_chip — the reference collected
     per-device history it never drew (SURVEY §2.1 gpuTemp); here every
     chip is clickable. When the fleet payload doesn't carry this
     chip's curves yet, fetch just them via the series= glob (cheap and
     epoch-cached server-side — the 256-chip path). */
  let chipSeriesFetched = null;  // chip a filtered fetch already ran for
  let chipChartKind = null;      // family the modal chart's labels speak
  function openChipModal(chipId) {
    currentChipId = chipId;
    $("chip-modal-title").textContent = chipId;
    $("chip-modal").classList.add("open");
    // GPU-aware units: the modal's series labels speak the clicked
    // chip's family (SM/VRAM vs MXU/HBM) — rebuilt only when the
    // family actually flips (mixed fleets).
    const cinfo = (streamData?.accel?.chips || []).find(c => c.chip === chipId);
    const kind = cinfo?.accel_kind || "tpu";
    const t = accelTerms(kind);
    if (!chipChart || chipChartKind !== kind) {
      chipChartKind = kind;
      chipChart = makeLineChart(mkSurface($("c-chip")),
        [{label:`${t.duty} duty %`, color:"#36d399", fill:true},
         {label:`${t.mem} %`, color:"#22d3ee"},
         {label:"link score ×10", color:"#f59e0b"}], {yMax:100, unit:"%"});
    }
    const mxu = lastHistory?.per_chip?.[chipId + ".mxu"];
    const hbm = lastHistory?.per_chip?.[chipId + ".hbm"];
    const link = lastHistory?.per_chip?.[chipId + ".link"];
    const has = mxu?.data?.length || hbm?.data?.length;
    $("chip-modal-empty").style.display = has ? "none" : "";
    $("c-chip").style.display = has ? "" : "none";
    chipChart.update((mxu?.labels?.length ? mxu.labels : hbm?.labels) || [],
                     [mxu?.data, hbm?.data, link?.data]);
    if (!has && chipSeriesFetched !== chipId) {
      chipSeriesFetched = chipId;  // once per chip until history refreshes
      const win = histWindow;  // a stale-window response must not merge
      net.getJson("/api/history?window=" + win +
                  "&series=chip." + chipId + ".*", h => {
        if (!h || !h.per_chip || currentChipId !== chipId ||
            win !== histWindow) return;
        if (!lastHistory) lastHistory = h;
        else {
          if (!lastHistory.per_chip) lastHistory.per_chip = {};
          for (const k of Object.keys(h.per_chip))
            lastHistory.per_chip[k] = h.per_chip[k];
        }
        openChipModal(chipId);
      });
    }
  }
  function closeChipModal() {
    currentChipId = null;
    $("chip-modal").classList.remove("open");
  }

  /* -------------------------------- pods ------------------------------- */
  function fetchPods() {
    net.getJson("/api/k8s/pods", res => {
      const body = $("pods-body");
      body.replaceChildren();
      const pods = res?.pods || [];
      $("pods-tag").textContent = pods.length;
      if (!pods.length) {
        const tr = doc.mk("tr");
        const td = doc.mk("td");
        td.colSpan = 8; td.style.color = "var(--dim)";
        td.textContent = res?.health?.error || "no pods";
        tr.appendChild(td); body.appendChild(tr);
        return;
      }
      for (const p of pods) {
        const tr = doc.mk("tr");
        for (const c of [p.namespace, p.name]) {
          const td = doc.mk("td"); td.textContent = c ?? ""; tr.appendChild(td);
        }
        const st = doc.mk("td");
        const badge = doc.mk("span");
        const b = podBadge(p);  // chartcore.js
        badge.className = b.cls;
        badge.textContent = b.text;
        st.appendChild(badge); tr.appendChild(st);
        for (const c of [p.restarts, p.age, p.node ?? "–",
                         p.tpu_topology ?? "–", podTpuCell(p)]) {
          const td = doc.mk("td"); td.textContent = c ?? ""; tr.appendChild(td);
        }
        body.appendChild(tr);
      }
    });
  }

  /* ------------------------------- alerts ------------------------------ */
  function fetchAlerts() {
    net.getJson("/api/alerts", a => {
      if (!a) return;
      currentAlerts = a;
      $("n-minor").textContent = (a.minor || []).length;
      $("n-serious").textContent = (a.serious || []).length;
      $("n-critical").textContent = (a.critical || []).length;
      $("crit-badge").classList.toggle("active", (a.critical || []).length > 0);
      $("overall-dot").className = overallDotClass(a);  // chartcore.js
      if ($("modal").classList.contains("open")) renderModal();
    });
  }

  const postAndRefresh = (url, payload) =>
    net.postJson(url, payload, () => fetchAlerts());
  // silencePrefix lives in chartcore.js (severity-leaf stripping).
  const silenceAlert = key =>
    postAndRefresh("/api/silence", { key: silencePrefix(key), duration: "1h" });
  const unsilenceAlert = key => postAndRefresh("/api/unsilence", { key: key });

  function renderModal() {
    const body = $("modal-body");
    body.replaceChildren();
    let any = false;
    for (const sev of ["critical", "serious", "minor"]) {
      for (const a of currentAlerts[sev] || []) {
        any = true;
        const card = doc.mk("div");
        card.className = "alert-card " + sev;
        const t = doc.mk("div"); t.className = "t"; t.textContent = a.title;
        if (a.key) {
          const btn = doc.mk("button");
          btn.className = "silence-btn"; btn.textContent = "silence 1h";
          btn.onclick = () => silenceAlert(a.key);
          t.appendChild(btn);
        }
        const d = doc.mk("div"); d.className = "d"; d.textContent = a.desc;
        const f = doc.mk("div"); f.className = "f"; f.textContent = a.fix;
        card.append(t, d, f); body.appendChild(card);
      }
    }
    for (const a of currentAlerts.silenced || []) {
      any = true;
      const card = doc.mk("div");
      card.className = "alert-card silenced";
      const t = doc.mk("div"); t.className = "t";
      t.textContent = `🔕 ${a.title}`;
      const d = doc.mk("div"); d.className = "d"; d.textContent = a.desc;
      card.append(t, d); body.appendChild(card);
    }
    // Active silences (a silence is a key *prefix*; unsilence removes it).
    for (const s of currentAlerts.silences || []) {
      any = true;
      const row = doc.mk("div");
      row.className = "alert-card silenced";
      const t = doc.mk("div"); t.className = "t";
      const mins = Math.max(0, (s.until * 1000 - env.nowMs()) / 60000);
      t.textContent = `silence "${s.key}" · ${mins.toFixed(0)} min left`;
      const btn = doc.mk("button");
      btn.className = "silence-btn"; btn.textContent = "unsilence";
      btn.onclick = () => unsilenceAlert(s.key);
      t.appendChild(btn);
      row.appendChild(t); body.appendChild(row);
    }
    if (!any) {
      const ok = doc.mk("div");
      ok.style.color = "var(--dim)"; ok.textContent = "No active alerts 🎉";
      body.appendChild(ok);
    }
    const events = currentAlerts.events || [];
    if (events.length) {
      const h = doc.mk("div");
      h.className = "events-h";
      h.textContent = "Recent events";
      body.appendChild(h);
      for (const e of events.slice(0, 20)) {
        const row = doc.mk("div");
        row.className = "event-row";
        const when = env.localeTime(e.ts * 1000);
        row.textContent =
          `${when}  ${e.state === "fired" ? "▲ fired" : "▽ resolved"}  ${e.title}`;
        row.style.color = e.state === "fired" ? "var(--text)" : "var(--dim)";
        body.appendChild(row);
      }
    }
  }
  function openModal() { renderModal(); $("modal").classList.add("open"); }
  function closeModal() { $("modal").classList.remove("open"); }

  /* --------------------------- serving & train ------------------------- */
  function fetchServing() {
    net.getJson("/api/serving", res => {
      const targets = res?.targets || [];
      const card = $("serving-card");
      if (!targets.length) {
        card.style.display = "none";
        $("train-card").style.display = "none";  // no targets => no stale panel
        return;
      }
      card.style.display = "";
      const ok = targets.filter(t => t.ok);
      $("serving-tag").textContent = `${ok.length}/${targets.length} targets up`;
      const agg = (vals, avg) => {
        let s = 0;
        for (const v of vals) s += v;
        return avg ? s / vals.length : s;
      };
      const pick = (k, fmt) => {
        const vals = ok.map(t => t[k]).filter(v => v != null);
        return vals.length ? fmt(agg(vals, k.slice(0, 4) === "ttft")) : "–";
      };
      $("sv-ttft").textContent = pick("ttft_p50_ms", v => v.toFixed(0) + " ms");
      $("sv-ttft99").textContent = pick("ttft_p99_ms", v => v.toFixed(0) + " ms");
      $("sv-tps").textContent = pick("tokens_per_sec", v => v.toFixed(1));
      $("sv-rps").textContent = pick("requests_per_sec", v => v.toFixed(2));
      $("sv-q").textContent = pick("queue_depth", v => v.toFixed(0));
      $("sv-wb").textContent = pick("weight_bytes", v =>
        v >= 2 ** 30 ? (v / 2 ** 30).toFixed(2) + " GiB"
                     : (v / 2 ** 20).toFixed(1) + " MiB");
      // Speculative-decoding acceptance (avg across targets exporting it).
      const specVals = ok.map(t => t.spec_accept_pct).filter(v => v != null);
      $("sv-spec").textContent = specVals.length
        ? (agg(specVals, true)).toFixed(1) + "%" : "–";
      // Prefix-cache hit rate (avg across targets exporting it).
      const pfxVals = ok.map(t => t.prefix_hit_pct).filter(v => v != null);
      $("sv-prefix").textContent = pfxVals.length
        ? (agg(pfxVals, true)).toFixed(1) + "%" : "–";
      // Paged KV pool occupancy (max across targets: the tightest pool).
      const kvVals = ok.map(t => t.kv_pages_used_pct).filter(v => v != null);
      $("sv-kv").textContent = kvVals.length
        ? Math.max(...kvVals).toFixed(0) + "%" : "–";
      // Training panel: targets exporting tpumon_train_* families.
      const trainers = ok.filter(t => t.train_step != null);
      const tcard = $("train-card");
      if (!trainers.length) { tcard.style.display = "none"; return; }
      tcard.style.display = "";
      $("train-tag").textContent = `${trainers.length} job(s)`;
      const tpick = (k, fmt) => {
        const vals = trainers.map(t => t[k]).filter(v => v != null);
        return vals.length ? fmt(agg(vals, true)) : "–";
      };
      $("tr-step").textContent = tpick("train_step", v => v.toFixed(0));
      $("tr-loss").textContent = tpick("train_loss", v => v.toFixed(3));
      $("tr-dt").textContent = tpick("train_step_time_ms", v => v.toFixed(0) + " ms");
      $("tr-tps").textContent = tpick("train_tokens_per_sec", v => v.toFixed(0));
      $("tr-gp").textContent = tpick("train_goodput_pct", v => v.toFixed(1) + "%");
      $("tr-mfu").textContent = tpick("train_mfu_pct", v => v.toFixed(1) + "%");
      $("tr-ckpt").textContent = tpick("train_ckpt_step", v => "step " + v.toFixed(0));
    });
  }

  /* --------------------------- federation fleet ------------------------ */
  /* GET /api/federation — the aggregator-tree fleet view (slices/chips
   * with dark/unreachable failure domains, per-downstream freshness,
   * uplink stream state). Hidden on a standalone monitor: the route
   * always answers, but only a hub (aggregator or root) or an uplinked
   * leaf has anything to show. */
  function fetchFederation() {
    net.getJson("/api/federation", res => {
      const card = $("federation-card");
      const fleet = res ? res.fleet : null;
      const uplink = res ? res.uplink : null;
      // A fleet block means this node aggregates a downstream tree:
      // the hottest-chips query upgrades to distributed (fleet=1).
      topchipsFleet = !!fleet;
      renderFleetWaterfall(res ? res.freshness : null);
      if (!res || (!fleet && !uplink)) {
        card.style.display = "none";
        return;
      }
      card.style.display = "";
      // Root HA leadership (tpumon.leader): which root leads, at what
      // fencing generation — a standby root labels itself plainly.
      const lead = res.leader || null;
      $("fed-tag").textContent = res.role +
        (res.node ? " · " + res.node : "") +
        (lead
          ? (lead.leader ? " · LEADER" : " · standby") +
            " gen " + lead.generation
          : "");
      const put = (id, v, fmt) => {
        $(id).textContent = v == null ? "–" : fmt(v);
      };
      put("fed-slices", fleet ? fleet.slices : null, v => v.toFixed(0));
      put("fed-chips", fleet ? fleet.chips : null, v => v.toFixed(0));
      // Per-accelerator-family partition: a mixed TPU/GPU
      // fleet says how many chips each family contributes — blank on
      // single-family fleets (nothing to partition).
      const byAccel = fleet ? fleet.by_accel : null;
      const fams = byAccel ? Object.keys(byAccel).sort() : [];
      $("fed-accel").textContent = fams.length > 1
        ? fams.map(k => `${k} ${byAccel[k].chips}`).join(" · ")
        : "";
      put("fed-dark", fleet ? fleet.dark_slices : null, v => v.toFixed(0));
      $("fed-dark").style.color =
        fleet && fleet.dark_slices > 0 ? "var(--red)" : "";
      put("fed-unreach", fleet ? fleet.unreachable_slices : null,
          v => v.toFixed(0));
      $("fed-unreach").style.color =
        fleet && fleet.unreachable_slices > 0 ? "var(--red)" : "";
      put("fed-duty", fleet ? fleet.duty_mean : null,
          v => v.toFixed(1) + "%");
      const nodes = res.nodes || {};
      const names = Object.keys(nodes);
      let up = 0;
      let oldest = null;
      for (const name of names) {
        const ns = nodes[name];
        if (ns.status === "ok") up += 1;
        if (ns.age_s != null && (oldest == null || ns.age_s > oldest))
          oldest = ns.age_s;
      }
      put("fed-nodes", names.length ? up + "/" + names.length : null,
          v => v);
      put("fed-age", oldest, v => v.toFixed(1) + " s");
      $("fed-uplink").textContent = uplink
        ? (uplink.connected ? "connected" : "down") : "–";
      $("fed-uplink").style.color =
        uplink && !uplink.connected ? "var(--red)" : "";
    });
  }

  /* ---------------------------- SLO burn-down -------------------------- */
  /* GET /api/slo — per-objective error budget + multi-window burn rates
   * (tpumon.slo, docs/slo.md). Hidden when no objectives are
   * configured: the route always answers, with an empty slos list. */
  function fetchSlo() {
    net.getJson("/api/slo", res => {
      const card = $("slo-card");
      const rows = res && res.slos ? res.slos : [];
      if (!rows.length) { card.style.display = "none"; return; }
      card.style.display = "";
      let firing = 0;
      const body = $("slo-body");
      body.replaceChildren();
      const burnText = b => {
        if (!b) return "–";
        const s = b.short == null ? "–" : b.short.toFixed(1) + "x";
        const l = b.long == null ? "–" : b.long.toFixed(1) + "x";
        return s + " / " + l + (b.firing ? " ● FIRING" : "");
      };
      for (const row of rows) {
        const tr = doc.mk("tr");
        const mk = (t, hot) => {
          const td = doc.mk("td");
          td.textContent = t;
          if (hot) td.style.color = "var(--red)";
          return td;
        };
        const budget = row.budget || {};
        const rem = budget.remaining;
        const fast = row.burn ? row.burn.fast : null;
        const slow = row.burn ? row.burn.slow : null;
        if (fast && fast.firing) firing += 1;
        if (slow && slow.firing) firing += 1;
        tr.appendChild(mk(row.name));
        tr.appendChild(mk(row.tenant || "–"));
        tr.appendChild(mk((row.target * 100).toFixed(2) + "%"));
        tr.appendChild(mk(
          rem == null ? "–" : (rem * 100).toFixed(1) + "%",
          rem != null && rem < 0.1));
        tr.appendChild(mk(burnText(fast), !!(fast && fast.firing)));
        tr.appendChild(mk(burnText(slow), !!(slow && slow.firing)));
        body.appendChild(tr);
      }
      $("slo-tag").textContent = firing
        ? firing + " burning" : rows.length + " objective(s)";
      $("slo-tag").style.color = firing ? "var(--red)" : "";
    });
  }

  /* ------------------------------ actuation ---------------------------- */
  /* The closed loop (tpumon/actuate.py, docs/actuation.md): per-policy
   * state machine rows + the last journaled transition. Primary feed is
   * the SSE realtime payload ("actuate" key — a firing policy repaints
   * on the very next tick); fetchActuate is the polling fallback.
   * Hidden when no policies are configured: the route always answers,
   * with an empty policies list. */
  function renderActuate(res) {
    const card = $("actuate-card");
    if (!card) return;
    const rows = res && res.policies ? res.policies : [];
    if (!rows.length) { card.style.display = "none"; return; }
    card.style.display = "";
    let firing = 0;
    let dry = 0;
    const body = $("actuate-body");
    body.replaceChildren();
    for (const row of rows) {
      const tr = doc.mk("tr");
      const mk = (t, hot) => {
        const td = doc.mk("td");
        td.textContent = t;
        if (hot) td.style.color = "var(--red)";
        return td;
      };
      if (row.state === "fired") firing += 1;
      if (row.dry_run) dry += 1;
      tr.appendChild(mk(row.name + (row.dry_run ? " (dry-run)" : "")));
      tr.appendChild(mk(row.action));
      tr.appendChild(mk(row.state, row.state === "fired"));
      tr.appendChild(mk(row.when));
      tr.appendChild(mk(row.value == null ? "–" : String(row.value)));
      tr.appendChild(mk(row.last || "–"));
      tr.appendChild(mk(row.fired + " / " + row.reverted));
      body.appendChild(tr);
    }
    $("actuate-tag").textContent =
      (firing ? firing + " active" : rows.length + " polic" +
        (rows.length === 1 ? "y" : "ies")) +
      (res.engine_bound ? "" : " · no engine") +
      (dry ? " · DRY-RUN" : "");
    $("actuate-tag").style.color = firing ? "var(--red)" : "";
  }

  function fetchActuate() {
    net.getJson("/api/actuate", renderActuate);
  }

  /* --------------------------- hottest chips --------------------------- */
  /* GET /api/query — the in-tree query engine (docs/query.md): a topk
   * over per-chip 5 m duty means. On an aggregator or root with a
   * downstream tree the same expression is planned as a DISTRIBUTED
   * query (fleet=1 merges partial aggregates from the leaves), so the
   * card works at fleet scale without shipping raw points. Hidden when
   * no chip.* series exist (chips absent or per-chip history off). */
  var topchipsFleet = false;  // flips on once /api/federation shows a hub
  function fetchTopChips() {
    /* No-spaces spelling: every character is URL-safe, so the query
     * string needs no encoding step. */
    const expr = "topk(5,avg_over_time(chip.mxu[5m]))";
    const qs = "/api/query?query=" + expr +
               (topchipsFleet ? "&fleet=1" : "");
    net.getJson(qs, res => {
      const card = $("topchips-card");
      const rows = res && res.result ? res.result : [];
      if (!rows.length) { card.style.display = "none"; return; }
      card.style.display = "";
      /* Always set (not only on partial): a recovered tree must clear
       * a previous cycle's "partial: missing ..." note. */
      $("topchips-tag").textContent = res.partial
        ? "partial: missing " + (res.missing || []).join(", ")
        : expr;
      const body = $("topchips-body");
      body.replaceChildren();
      for (const row of rows) {
        const labels = row.labels || {};
        const tr = doc.mk("tr");
        const mk = t => {
          const td = doc.mk("td");
          td.textContent = t;
          return td;
        };
        tr.appendChild(mk(labels.chip || "–"));
        tr.appendChild(mk(labels.host || "–"));
        tr.appendChild(mk(labels.pod || "–"));
        tr.appendChild(mk(row.value == null ? "–" : row.value.toFixed(1) + "%"));
        body.appendChild(tr);
      }
    });
  }

  /* ------------------------------- health ------------------------------ */
  function fetchHealth() {
    net.getJson("/api/health", h => {
      const strip = $("health");
      strip.replaceChildren();
      if (!h) return;
      const sources = h.sources || {};
      for (const name of Object.keys(sources)) {
        const s = sources[name];
        const el = doc.mk("div");
        // A breaker that left "closed" means the source is polled on a
        // backoff cadence and its panels are stale — as loud as a
        // failing scrape even if the last sample happened to succeed.
        const broken = s.breaker && s.breaker.state !== "closed";
        el.className = "src " + (s.ok && !broken ? "ok" : "bad");
        const dot = doc.mk("i");
        const label = doc.mk("span");
        label.textContent = `${name} · ${s.latency_p50_ms ?? "?"} ms p50` +
          (s.ok ? "" : ` · ${(s.error || "down").slice(0, 60)}`) +
          (broken ? ` · breaker ${s.breaker.state}` +
            (s.breaker.retry_in_s != null
              ? ` (retry ${s.breaker.retry_in_s.toFixed(0)}s)` : "")
            : "");
        el.append(dot, label);
        // Source caveats (e.g. "temp_c unavailable", "duty/HBM include
        // workload self-reports") — declared, not silently missing.
        if (s.notes && s.notes.length) {
          el.title = s.notes.join("\n");
          const note = doc.mk("span");
          note.textContent = " ⓘ";
          note.style.opacity = "0.6";
          el.appendChild(note);
        }
        strip.appendChild(el);
      }
    });
  }

  function updateTime() { $("clock").textContent = env.timeStr(); }

  function fetchAll() {
    fetchRealtime(); fetchHistory(); fetchPods();
    fetchAlerts(); fetchServing(); fetchFederation(); fetchHealth();
    fetchSlo(); fetchActuate();
    fetchTopChips();
    fetchTrace();
    fetchEvents();
    updateTime();
  }

  return {
    charts: charts,
    fetchRealtime: fetchRealtime, fetchHistory: fetchHistory,
    fetchPods: fetchPods, fetchAlerts: fetchAlerts,
    fetchServing: fetchServing, fetchFederation: fetchFederation,
    fetchHealth: fetchHealth, fetchTopChips: fetchTopChips,
    fetchSlo: fetchSlo, fetchActuate: fetchActuate,
    renderActuate: renderActuate,
    fetchTrace: fetchTrace, fetchEvents: fetchEvents,
    fetchAll: fetchAll, updateTime: updateTime,
    onStreamFrame: onStreamFrame, setWindow: setWindow,
    renderTrace: renderTrace, renderEvents: renderEvents,
    setEventFilter: setEventFilter,
    openModal: openModal, closeModal: closeModal,
    openChipModal: openChipModal, closeChipModal: closeChipModal,
    topoTipAt: topoTipAt, topoClickAt: topoClickAt,
  };
}
