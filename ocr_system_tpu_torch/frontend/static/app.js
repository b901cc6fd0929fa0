/* OCR System TPU — single-page frontend.
 *
 * Covers the reference Streamlit app's flows (frontend/pages/1_Upload.py,
 * 2_History.py, 3_Dashboard.py): upload + processing queue poll, review/edit
 * with bbox overlay, dashboard charts. Vanilla JS against the REST API.
 */

const api = {
  async req(method, path, body, isForm) {
    const opts = { method, headers: {} };
    if (body && !isForm) {
      opts.headers["Content-Type"] = "application/json";
      opts.body = JSON.stringify(body);
    } else if (body) {
      opts.body = body;
    }
    const resp = await fetch(path, opts);
    const data = await resp.json().catch(() => ({}));
    if (!resp.ok) throw new Error(data.detail || resp.statusText);
    return data;
  },
  get: (p) => api.req("GET", p),
  post: (p, b) => api.req("POST", p, b),
  patch: (p, b) => api.req("PATCH", p, b),
};

function toast(msg) {
  const el = document.getElementById("toast");
  el.textContent = msg;
  el.classList.add("show");
  setTimeout(() => el.classList.remove("show"), 2500);
}

/* ---------- routing ---------- */

const pages = ["upload", "documents", "dashboard", "review"];
let pollTimer = null;

function navigate() {
  const hash = location.hash.slice(1) || "upload";
  const [page, arg] = hash.split("/");
  pages.forEach((p) => {
    document.getElementById(`page-${p}`)?.classList.toggle("visible", p === page);
  });
  document.querySelectorAll(".navlink").forEach((a) =>
    a.classList.toggle("active", a.dataset.page === page)
  );
  clearInterval(pollTimer);
  if (page === "upload")
    loadTemplates(), renderQueue(), (pollTimer = setInterval(renderQueue, 2000));
  if (page === "documents") renderDocuments();
  if (page === "dashboard") renderDashboard();
  if (page === "review" && arg) openReview(arg);
}
window.addEventListener("hashchange", navigate);

/* ---------- upload ---------- */

const dropzone = document.getElementById("dropzone");
const fileInput = document.getElementById("file-input");

async function loadTemplates() {
  const sel = document.getElementById("template-select");
  if (!sel || sel.dataset.loaded) return;
  const data = await api.get("/api/templates").catch(() => null);
  if (!data) return;
  sel.dataset.loaded = "1";
  (data.items || []).forEach((t) => {
    const o = document.createElement("option");
    o.value = t.name;
    o.textContent = t.name;
    sel.appendChild(o);
  });
}

async function doUpload(file) {
  const fd = new FormData();
  fd.append("file", file);
  fd.append("auto_extract", document.getElementById("auto-extract").checked);
  const tmpl = document.getElementById("template-select")?.value;
  if (tmpl) fd.append("template_name", tmpl);
  document.getElementById("upload-status").textContent = `Uploading ${file.name}…`;
  try {
    const doc = await api.req("POST", "/api/documents/upload", fd, true);
    document.getElementById("upload-status").textContent =
      `Uploaded ${doc.original_filename} (${doc.file_size_human})`;
    renderQueue();
  } catch (e) {
    document.getElementById("upload-status").textContent = `Upload failed: ${e.message}`;
  }
}

fileInput?.addEventListener("change", () => fileInput.files[0] && doUpload(fileInput.files[0]));
["dragover", "dragleave", "drop"].forEach((ev) =>
  dropzone?.addEventListener(ev, (e) => {
    e.preventDefault();
    dropzone.classList.toggle("drag", ev === "dragover");
    if (ev === "drop" && e.dataTransfer.files[0]) doUpload(e.dataTransfer.files[0]);
  })
);

async function renderQueue() {
  const data = await api.get("/api/documents?page_size=8").catch(() => null);
  if (!data) return;
  document.getElementById("recent-queue").innerHTML = data.items
    .map((d) => docCard(d))
    .join("") || "<p class='vmsg'>No documents yet.</p>";
}

function docCard(d) {
  return `<div class="doc-card" onclick="location.hash='review/${d.id}'">
    <span>${d.original_filename} <span class="vmsg">${d.file_size_human}</span></span>
    <span class="badge ${d.status}">${d.status_display}</span>
  </div>`;
}

/* ---------- documents list ---------- */

async function renderDocuments() {
  const q = document.getElementById("doc-search").value;
  const data = await api.get(`/api/documents?page_size=50&search=${encodeURIComponent(q)}`)
    .catch(() => ({ items: [] }));
  document.getElementById("doc-list").innerHTML =
    data.items.map(docCard).join("") || "<p class='vmsg'>Nothing found.</p>";
}
document.getElementById("doc-search")?.addEventListener("input", renderDocuments);

/* ---------- review ---------- */

const review = { doc: null, ext: null, page: 1, selected: null, edits: {} };

// ---- viewer zoom/pan (reference parity: interactive_viewer.py:57-94's
// zoomable review surface). A CSS transform on #viewer-zoom moves the
// page image and the SVG overlay TOGETHER, so boxes stay registered at
// any zoom — the overlay keeps its page-pixel viewBox.
const zoom = { z: 1, x: 0, y: 0 };

function applyZoom() {
  const el = document.getElementById("viewer-zoom");
  if (!el) return;
  el.style.transform = `translate(${zoom.x}px, ${zoom.y}px) scale(${zoom.z})`;
  const lvl = document.getElementById("zoom-level");
  if (lvl) lvl.textContent = `${Math.round(zoom.z * 100)}%`;
}

function resetZoom() { zoom.z = 1; zoom.x = 0; zoom.y = 0; applyZoom(); }

function zoomAt(cx, cy, factor) {
  const nz = Math.min(8, Math.max(1, zoom.z * factor));
  const f = nz / zoom.z;
  // keep the point under the cursor fixed: p' = c + f*(p - c)
  zoom.x = cx + f * (zoom.x - cx);
  zoom.y = cy + f * (zoom.y - cy);
  zoom.z = nz;
  if (zoom.z === 1) { zoom.x = 0; zoom.y = 0; }
  applyZoom();
}

(function wireZoom() {
  const canvas = document.getElementById("viewer-canvas");
  if (!canvas) return;
  canvas.addEventListener("wheel", (ev) => {
    ev.preventDefault();
    const r = canvas.getBoundingClientRect();
    zoomAt(ev.clientX - r.left, ev.clientY - r.top, ev.deltaY < 0 ? 1.2 : 1 / 1.2);
  }, { passive: false });
  let drag = null;
  canvas.addEventListener("mousedown", (ev) => {
    if (zoom.z <= 1) return;
    drag = { x: ev.clientX - zoom.x, y: ev.clientY - zoom.y };
    canvas.classList.add("panning");
    ev.preventDefault();
  });
  window.addEventListener("mousemove", (ev) => {
    if (!drag) return;
    zoom.x = ev.clientX - drag.x;
    zoom.y = ev.clientY - drag.y;
    applyZoom();
  });
  window.addEventListener("mouseup", () => {
    drag = null;
    canvas.classList.remove("panning");
  });
  canvas.addEventListener("dblclick", resetZoom);
  document.getElementById("zoom-in")?.addEventListener("click", () => {
    const r = canvas.getBoundingClientRect();
    zoomAt(r.width / 2, r.height / 2, 1.25);
  });
  document.getElementById("zoom-out")?.addEventListener("click", () => {
    const r = canvas.getBoundingClientRect();
    zoomAt(r.width / 2, r.height / 2, 1 / 1.25);
  });
  document.getElementById("zoom-reset")?.addEventListener("click", resetZoom);
})();

async function openReview(docId) {
  review.edits = {};
  review.selected = null;
  review.page = 1;
  // reset zoom when opening a DIFFERENT document (the 3 s processing poll
  // re-enters here for the same doc — don't fight the user's zoom)
  if (review.doc?.id !== docId) resetZoom();
  const doc = await api.get(`/api/documents/${docId}`).catch((e) => (toast(e.message), null));
  if (!doc) return;
  review.doc = doc;
  document.getElementById("review-title").textContent = doc.original_filename;
  if (doc.status === "processing" || doc.status === "pending") {
    document.getElementById("review-meta").textContent = "Processing… (auto-refresh)";
    pollTimer = setInterval(() => openReview(docId), 3000);
    return;
  }
  clearInterval(pollTimer);
  const current = doc.extractions?.find((e) => e.is_current) || doc.extractions?.[0];
  if (!current) {
    document.getElementById("review-meta").textContent = "No extraction yet.";
    return;
  }
  review.ext = await api.get(`/api/extractions/${current.id}`);
  const e = review.ext;
  document.getElementById("review-meta").innerHTML =
    `<span class="badge ${e.status}">${e.status}</span> · ${e.form_type || "Unknown"} · ` +
    `v${e.version} · ${e.total_fields} fields · ` +
    `avg conf ${(100 * (e.avg_confidence || 0)).toFixed(0)}%` +
    (e.is_finalized ? " · 🔒 finalized" : "");
  ["json", "csv", "excel", "pdf"].forEach((f) => {
    document.getElementById(`exp-${f}`).href = `/api/exports/extraction/${e.id}/${f}`;
  });
  renderViewer();
  renderFields();
}

function pageCount() {
  return Object.keys(review.ext?.page_dimensions || { 1: 1 }).length || 1;
}

function renderViewer() {
  const e = review.ext;
  const img = document.getElementById("page-image");
  img.src = `/api/documents/${review.doc.id}/processed-image/${review.page}`;
  document.getElementById("page-indicator").textContent =
    `page ${review.page} / ${pageCount()}`;
  img.onload = renderOverlay;
  renderOverlay();
}

function renderOverlay() {
  const e = review.ext;
  const svg = document.getElementById("overlay");
  const dims = (e.page_dimensions || {})[String(review.page)] || { width: 1, height: 1 };
  svg.setAttribute("viewBox", `0 0 ${dims.width} ${dims.height}`);
  svg.setAttribute("preserveAspectRatio", "none");
  let polys = [];
  if (document.getElementById("show-all-boxes").checked) {
    (e.layout_data || [])
      .filter((b) => b.page_number === review.page && b.type === "word")
      .forEach((b) => polys.push(polyEl(b.polygon, "all")));
    (e.layout_data || [])
      .filter((b) => b.page_number === review.page &&
                     (b.type === "selection_mark" || b.type === "handwriting"))
      .forEach((b) => polys.push(polyEl(b.polygon, b.type === "selection_mark"
        ? (b.state === "selected" ? "mark-on" : "mark-off") : "hand")));
  }
  const f = (e.fields || []).find((x) => x.id === review.selected);
  if (f) {
    if (f.key_bbox?.page === review.page) polys.push(polyEl(f.key_bbox.polygon, "key"));
    if (f.value_bbox?.page === review.page) polys.push(polyEl(f.value_bbox.polygon, "value"));
  }
  svg.innerHTML = polys.join("");
}

function polyEl(flat, cls) {
  if (!flat || flat.length < 8) return "";
  const pts = [];
  for (let i = 0; i < 8; i += 2) pts.push(`${flat[i]},${flat[i + 1]}`);
  return `<polygon class="${cls}" points="${pts.join(" ")}"/>`;
}

document.getElementById("page-prev")?.addEventListener("click", () => {
  review.page = Math.max(1, review.page - 1); renderViewer();
});
document.getElementById("page-next")?.addEventListener("click", () => {
  review.page = Math.min(pageCount(), review.page + 1); renderViewer();
});
document.getElementById("show-all-boxes")?.addEventListener("change", renderOverlay);

// confidence / review-state filter (reference premium_fields.py filter
// dropdown + valid checkboxes)
function fieldVisible(f) {
  switch (review.filter || "all") {
    case "low": return (f.confidence || 0) < 0.6;
    case "review": return !!f.needs_review;
    case "unverified": return f.is_valid !== true && f.is_valid !== 1;
    default: return true;
  }
}

function renderFields() {
  const e = review.ext;
  const host = document.getElementById("fields-list");
  const all = e.fields || [];
  const shown = all.filter(fieldVisible);
  host.innerHTML = shown
    .map(
      (f) => `<div class="field-card ${f.id === review.selected ? "selected" : ""}" data-id="${f.id}">
      <div class="field-key" onclick="selectField('${f.id}')">
        <span>${f.confidence_icon} ${f.field_key || "(unnamed)"}</span>
        <span class="vmsg">${f.confidence_percent}%</span>
      </div>
      <textarea data-id="${f.id}" rows="1" ${e.is_finalized ? "disabled" : ""}>${f.field_value ?? ""}</textarea>
      <div class="vmsg">
        <label><input type="checkbox" class="valid-box" data-id="${f.id}"
          ${f.is_valid ? "checked" : ""} ${e.is_finalized ? "disabled" : ""}> valid</label>
        · ${f.field_type}${f.validation_message ? " · " + f.validation_message : ""}${f.is_edited ? " · edited" : ""}${f.needs_review ? " · ⚠ review" : ""}
      </div>
    </div>`
    )
    .join("") ||
    `<p class='vmsg'>${all.length ? "No fields match the filter." : "No fields extracted."}</p>`;
  host.querySelectorAll("textarea").forEach((t) =>
    t.addEventListener("input", () => (review.edits[t.dataset.id] = t.value))
  );
  // reviewer verdict round-trips immediately (PATCH {is_valid}) — it is a
  // review action, not a buffered edit
  host.querySelectorAll(".valid-box").forEach((c) =>
    c.addEventListener("change", async () => {
      await api
        .patch(`/api/extractions/${e.id}/fields/${c.dataset.id}`,
               { is_valid: c.checked })
        .catch((err) => toast(err.message));
      const f = all.find((x) => x.id === c.dataset.id);
      if (f) { f.is_valid = c.checked; f.needs_review = !c.checked; }
    })
  );
  document.getElementById("finalize-btn").disabled = !!e.is_finalized;
  document.getElementById("save-all").disabled = !!e.is_finalized;
  document.getElementById("add-field-btn").disabled = !!e.is_finalized;
}

document.getElementById("conf-filter")?.addEventListener("change", (ev) => {
  review.filter = ev.target.value;
  if (review.ext) renderFields();
});

// ---- extraction chat (POST /api/extractions/{id}/chat; history
// round-trips so follow-ups like "and its confidence?" resolve server-side)
const chat = { history: [] };

function chatAppend(role, text) {
  const log = document.getElementById("chat-log");
  const div = document.createElement("div");
  div.className = `chat-msg ${role}`;
  div.textContent = text;
  log.appendChild(div);
  log.scrollTop = log.scrollHeight;
}

async function chatSend() {
  const input = document.getElementById("chat-input");
  const msg = input.value.trim();
  if (!msg || !review.ext) return;
  input.value = "";
  chatAppend("user", msg);
  const out = await api
    .post(`/api/extractions/${review.ext.id}/chat`,
          { message: msg, history: chat.history })
    .catch((e) => (toast(e.message), null));
  if (!out) return;
  chat.history = out.history;
  chatAppend("assistant", out.reply);
  // jump the viewer to the first field the answer cites
  const hit = (out.matched_fields || [])
    .map((k) => (review.ext.fields || []).find((f) => f.field_key === k))
    .find(Boolean);
  if (hit) selectField(hit.id);
}

document.getElementById("chat-send")?.addEventListener("click", chatSend);
document.getElementById("chat-input")?.addEventListener("keydown", (ev) => {
  if (ev.key === "Enter") chatSend();
});

window.selectField = function (id) {
  review.selected = id;
  const f = review.ext.fields.find((x) => x.id === id);
  const target = f?.value_bbox?.page || f?.key_bbox?.page;
  if (target && target !== review.page) { review.page = target; renderViewer(); }
  renderOverlay();
  document.querySelectorAll(".field-card").forEach((c) =>
    c.classList.toggle("selected", c.dataset.id === id)
  );
};

document.getElementById("save-all")?.addEventListener("click", async () => {
  const ids = Object.keys(review.edits);
  if (!ids.length) return toast("No edits to save");
  for (const id of ids) {
    await api
      .patch(`/api/extractions/${review.ext.id}/fields/${id}`, { field_value: review.edits[id] })
      .catch((e) => toast(e.message));
  }
  toast(`Saved ${ids.length} field(s)`);
  openReview(review.doc.id);
});

document.getElementById("add-field-btn")?.addEventListener("click", async () => {
  const key = document.getElementById("new-field-key").value.trim();
  if (!key) return toast("Field name required");
  await api
    .post(`/api/extractions/${review.ext.id}/fields`, {
      field_key: key,
      field_value: document.getElementById("new-field-value").value,
      field_type: document.getElementById("new-field-type").value,
      page_number: review.page,
    })
    .then(() => {
      toast(`Added "${key}"`);
      document.getElementById("new-field-key").value = "";
      document.getElementById("new-field-value").value = "";
      openReview(review.doc.id);
    })
    .catch((e) => toast(e.message));
});

document.getElementById("validate-btn")?.addEventListener("click", async () => {
  const r = await api.post(`/api/extractions/${review.ext.id}/validate`, {}).catch((e) => toast(e.message));
  if (r) toast(`Valid ${r.valid_fields}/${r.total_fields}, review ${r.needs_review}`);
  openReview(review.doc.id);
});

document.getElementById("finalize-btn")?.addEventListener("click", async () => {
  if (!confirm("Finalize this extraction? It becomes read-only.")) return;
  await api.post(`/api/extractions/${review.ext.id}/finalize`, { confirm: true })
    .then(() => (toast("Finalized"), openReview(review.doc.id)))
    .catch((e) => toast(e.message));
});

/* ---------- dashboard ---------- */

async function renderDashboard() {
  const d = await api.get("/api/stats/dashboard").catch(() => null);
  if (!d) return;
  const m = document.getElementById("metric-row");
  m.innerHTML = [
    ["Documents", d.documents.total],
    ["Completed extractions", d.extractions.completed],
    ["Fields extracted", d.fields.total],
    ["Avg confidence", d.fields.avg_confidence ? (100 * d.fields.avg_confidence).toFixed(1) + "%" : "—"],
    ["Avg processing", d.processing.avg_total_ms ? d.processing.avg_total_ms.toFixed(0) + " ms" : "—"],
    ["Edit rate", (100 * d.fields.edit_rate).toFixed(1) + "%"],
  ]
    .map(([l, v]) => `<div class="metric"><div class="v">${v}</div><div class="l">${l}</div></div>`)
    .join("");
  pieChart("chart-status", d.documents.by_status);
  barChart("chart-forms", d.extractions.by_form_type);
  const p = await api.get("/api/stats/processing").catch(() => null);
  if (p) {
    document.getElementById("steps-table").innerHTML =
      `<table><tr><th>Step</th><th>Completed</th><th>Failed</th><th>avg ms</th></tr>` +
      Object.entries(p.steps)
        .map(
          ([s, v]) =>
            `<tr><td>${s}</td><td>${v.completed || 0}</td><td>${v.failed || 0}</td>` +
            `<td>${v.duration_ms?.avg ? v.duration_ms.avg.toFixed(0) : "—"}</td></tr>`
        )
        .join("") + `</table>`;
  }
}

// status distribution pie (reference frontend/pages/3_Dashboard.py:59-102)
function pieChart(svgId, data) {
  const svg = document.getElementById(svgId);
  const entries = Object.entries(data || {}).filter(([, v]) => v > 0);
  if (!entries.length) { svg.innerHTML = ""; return; }
  const W = 400, H = 200, cx = 110, cy = 100, r = 80;
  const total = entries.reduce((s, [, v]) => s + v, 0);
  const colors = { completed: "#35c46f", processing: "#4f8cff",
                   pending: "#d9a53a", failed: "#e0564f" };
  const fallback = ["#4f8cff", "#35c46f", "#d9a53a", "#e0564f", "#9b6fe0"];
  svg.setAttribute("viewBox", `0 0 ${W} ${H}`);
  let angle = -Math.PI / 2, i = 0;
  const parts = [], legend = [];
  for (const [k, v] of entries) {
    const frac = v / total;
    const a2 = angle + frac * 2 * Math.PI;
    const fill = colors[k] || fallback[i % fallback.length];
    if (entries.length === 1 || frac > 0.999) {
      parts.push(`<circle cx="${cx}" cy="${cy}" r="${r}" fill="${fill}"/>`);
    } else {
      const x1 = cx + r * Math.cos(angle), y1 = cy + r * Math.sin(angle);
      const x2 = cx + r * Math.cos(a2), y2 = cy + r * Math.sin(a2);
      const big = frac > 0.5 ? 1 : 0;
      parts.push(
        `<path d="M${cx},${cy} L${x1.toFixed(1)},${y1.toFixed(1)} ` +
        `A${r},${r} 0 ${big} 1 ${x2.toFixed(1)},${y2.toFixed(1)} Z" fill="${fill}"/>`
      );
    }
    legend.push(
      `<rect x="230" y="${30 + i * 24}" width="12" height="12" rx="2" fill="${fill}"/>` +
      `<text x="248" y="${41 + i * 24}" fill="#e8ecf4" font-size="12">${k} — ${v} (${(100 * frac).toFixed(0)}%)</text>`
    );
    angle = a2; i += 1;
  }
  svg.innerHTML = parts.join("") + legend.join("");
}

function barChart(svgId, data) {
  const svg = document.getElementById(svgId);
  const entries = Object.entries(data || {});
  if (!entries.length) { svg.innerHTML = ""; return; }
  const W = 400, H = 200, max = Math.max(...entries.map(([, v]) => v));
  const bw = Math.min(70, (W - 20) / entries.length - 10);
  svg.setAttribute("viewBox", `0 0 ${W} ${H}`);
  svg.innerHTML = entries
    .map(([k, v], i) => {
      const h = (v / max) * (H - 50);
      const x = 15 + i * (bw + 12);
      return `<rect x="${x}" y="${H - 30 - h}" width="${bw}" height="${h}" rx="4" fill="#4f8cff"/>
        <text x="${x + bw / 2}" y="${H - 34 - h}" text-anchor="middle" fill="#e8ecf4" font-size="12">${v}</text>
        <text x="${x + bw / 2}" y="${H - 12}" text-anchor="middle" fill="#8b94a7" font-size="11">${k}</text>`;
    })
    .join("");
}

navigate();
