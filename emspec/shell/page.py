"""The shell's single-page UI (embedded: the shell must run from a bare
checkout with zero web tooling).  Mirrors the reference settings panel
(reference: assets/settings.png — FFT Size, Colormap, Brightness, dB
Range, Gain, Freq Scale, Low End Boost, Noise Gate, AGC Strength,
Smoothing, Scroll Speed, preset dropdown, Enhanced/Natural/On Top/Auto
Gain buttons, version header) over the HTTP API in server.py."""

PAGE = r"""<!DOCTYPE html>
<html>
<head>
<meta charset="utf-8">
<title>emspec</title>
<style>
  :root { color-scheme: dark; }
  body { margin:0; background:#0d0d10; color:#ddd;
         font:13px system-ui, sans-serif; display:flex; }
  #view { flex:1; display:flex; align-items:center; justify-content:center;
          min-height:100vh; position:relative; }
  canvas { image-rendering: pixelated; width:100%; height:100%;
           max-height:100vh; object-fit:fill; }
  #panel { width:300px; padding:14px; background:#16161c; overflow-y:auto;
           max-height:100vh; box-sizing:border-box; border-left:1px solid #26262e; }
  h1 { font-size:15px; margin:0 0 2px; }
  .ver { color:#777; font-size:11px; margin-bottom:10px; }
  label { display:block; margin:10px 0 2px; color:#aaa; font-size:11px;
          text-transform:uppercase; letter-spacing:.05em; }
  .val { float:right; color:#eee; }
  input[type=range] { width:100%; }
  select, button { background:#22222a; color:#ddd; border:1px solid #333;
                   border-radius:4px; padding:4px 8px; }
  select { width:100%; }
  .row { display:flex; gap:6px; margin-top:8px; }
  .row button { flex:1; }
  button.on { background:#5a3dbd; border-color:#7a5de0; }
  #tip { position:absolute; pointer-events:none; background:#000c;
         padding:3px 7px; border-radius:4px; font-size:12px; display:none; }
  #axis { position:absolute; inset:0; pointer-events:none; }
  .tick { position:absolute; left:0; width:100%; height:0;
          border-top:1px solid #ffffff22; }
  .tick span { position:absolute; left:4px; top:-14px; color:#ffffff88;
               font-size:10px; background:#0008; padding:0 3px;
               border-radius:2px; }
  #status { margin-top:12px; color:#6a6; font-size:11px; min-height:14px; }
  #minimized { position:absolute; inset:0; background:#0d0d10f0;
               display:none; align-items:center; justify-content:center;
               color:#888; font-size:18px; }
</style>
</head>
<body>
<div id="view">
  <canvas id="c"></canvas>
  <div id="axis"></div>
  <div id="tip"></div>
  <div id="minimized">minimized (Max-for-Live) — restore in Ableton</div>
</div>
<div id="panel">
  <h1>EM-Spec <span style="color:#7a5de0">jax</span></h1>
  <div class="ver" id="version"></div>

  <label>Preset</label>
  <select id="preset"></select>
  <div class="row">
    <button onclick="presetOp('save')">Add/Save</button>
    <button onclick="presetOp('delete')">Delete</button>
  </div>

  <div class="row">
    <button id="mode_enhanced" onclick="setS({mode:'enhanced'})">Enhanced</button>
    <button id="mode_natural" onclick="setS({mode:'natural'})">Natural</button>
  </div>
  <div class="row">
    <button id="on_top" onclick="toggle('on_top')">On Top</button>
    <button id="auto_gain" onclick="toggle('auto_gain')">Auto Gain</button>
  </div>
  <div class="row">
    <button id="record" onclick="record()">Record 5s</button>
  </div>

  <label id="chan_label" style="display:none">Channel</label>
  <select id="display_channel" style="display:none"
          onchange="setS({display_channel:+this.value})"></select>

  <label>FFT Size</label>
  <select id="fft_size" onchange="setS({fft_size:+this.value})"></select>
  <label>Colormap</label>
  <select id="colormap" onchange="setS({colormap:this.value})"></select>

  <div id="sliders"></div>
  <div id="status"></div>
</div>
<script>
const SLIDERS = [
  ["brightness",   0, 1,    0.01, v=>Math.round(v*100)+"%"],
  ["db_range",     20, 120, 1,    v=>v],
  ["gain",         0.1, 16, 0.1,  v=>v],
  ["freq_scale",   0.25, 4, 0.05, v=>v],
  ["low_end_boost",1, 10,   0.1,  v=>v+"x"],
  ["noise_gate_db",-120, 0, 1,    v=>v+" dB"],
  ["agc_strength", 0, 2,    0.05, v=>v],
  ["smoothing",    0, 0.99, 0.01, v=>v],
  ["scroll_speed", 0.25, 4, 0.25, v=>v+"x"],
];
const NAMES = {brightness:"Brightness", db_range:"dB Range", gain:"Gain",
  freq_scale:"Freq Scale", low_end_boost:"Low End Boost",
  noise_gate_db:"Noise Gate", agc_strength:"AGC Strength",
  smoothing:"Smoothing", scroll_speed:"Scroll Speed"};
let S = null;

function el(id){ return document.getElementById(id); }

function showUpdate(u) {
  // update notice in the settings header (reference README.md:53-55)
  if (!u || !u.latest) return;
  el("version").textContent = "Current Version: v" + u.current +
    "  ·  update available: v" + u.latest + (u.url ? "  ·  " + u.url : "");
}

function buildPanel(meta) {
  el("version").textContent = "Current Version: v" + meta.version +
    "  ·  backend: " + meta.backend;
  showUpdate(meta.update);
  for (const n of meta.fft_sizes) {
    const o = document.createElement("option"); o.value=o.textContent=n;
    el("fft_size").appendChild(o);
  }
  for (const n of meta.colormaps) {
    const o = document.createElement("option"); o.value=o.textContent=n;
    el("colormap").appendChild(o);
  }
  if (meta.on_top_supported === false) {
    // honest affordance: a browser tab can't be topmost — only the
    // native window (emspec gui --native) honors On-Top
    const b = el("on_top");
    b.disabled = true; b.onclick = null; b.style.opacity = 0.45;
    b.title = "Always-On-Top needs the native window: emspec gui --native";
  }
  const holder = el("sliders");
  for (const [f, lo, hi, st, fmt] of SLIDERS) {
    const lab = document.createElement("label");
    lab.innerHTML = NAMES[f] + ' <span class="val" id="val_'+f+'"></span>';
    const r = document.createElement("input");
    r.type="range"; r.min=lo; r.max=hi; r.step=st; r.id="sl_"+f;
    r.oninput = () => { el("val_"+f).textContent = fmt(+r.value);
                        setS({[f]: +r.value}); };
    holder.appendChild(lab); holder.appendChild(r);
  }
}

function reflect() {
  for (const [f,,,,fmt] of SLIDERS) {
    el("sl_"+f).value = S[f]; el("val_"+f).textContent = fmt(S[f]);
  }
  if (S.channels > 1) {
    const sel = el("display_channel");
    if (sel.options.length !== S.channels) {
      sel.innerHTML = "";
      for (let c = 0; c < S.channels; c++) {
        const o = document.createElement("option");
        o.value = c; o.textContent = "ch " + c; sel.appendChild(o);
      }
    }
    sel.value = S.display_channel;
    sel.style.display = el("chan_label").style.display = "block";
  }
  el("fft_size").value = S.fft_size;
  el("colormap").value = S.colormap;
  el("mode_enhanced").className = S.mode==="enhanced" ? "on":"";
  el("mode_natural").className = S.mode==="natural" ? "on":"";
  el("on_top").className = S.on_top ? "on":"";
  el("auto_gain").className = S.auto_gain ? "on":"";
}

async function setS(changes) {
  const r = await fetch("/api/settings", {method:"POST",
    body: JSON.stringify(changes)});
  const d = await r.json();
  S = d.settings;
  el("status").textContent = d.kind === "continuous"
    ? "continuous — no recompile"
    : d.kind === "structural" ? "structural — re-specialized" : "";
  reflect(); loadAxis();
}

async function loadAxis() {
  // frequency ruler: server-computed ticks follow the live zoom
  const ticks = await (await fetch("/api/axis")).json();
  const ax = el("axis"); ax.innerHTML = "";
  for (const t of ticks) {
    const d = document.createElement("div");
    d.className = "tick"; d.style.top = ((1 - t.frac) * 100) + "%";
    d.innerHTML = "<span>" + t.label + "</span>";
    ax.appendChild(d);
  }
}
function toggle(f){ setS({[f]: !S[f]}); }

async function record() {
  // capture the next 5 s of the live display server-side as an APNG
  // (the screen-recording analog of the reference window) and save it
  const b = el("record");
  b.disabled = true; b.textContent = "Recording…";
  try {
    const r = await fetch("/api/record?seconds=5&fps=15");
    if (!r.ok) {
      // a 400/500 body is JSON, not an APNG — surface it instead of
      // silently downloading the error as a .png (ADVICE r4)
      let msg = "recording failed (" + r.status + ")";
      try { msg += ": " + (await r.json()).error; } catch (e) {}
      b.textContent = msg;
      await new Promise(res => setTimeout(res, 2500));
      return;
    }
    const blob = await r.blob();
    const a = document.createElement("a");
    a.href = URL.createObjectURL(blob);
    a.download = "emspec_recording.png";     // APNG inside a .png
    a.click();
    URL.revokeObjectURL(a.href);
  } finally {
    b.disabled = false; b.textContent = "Record 5s";
  }
}

async function presetOp(op) {
  const sel = el("preset");
  let name = sel.value;
  if (op === "save") { name = prompt("preset name", name || "Custom");
                       if (!name) return; }
  await fetch("/api/preset/"+op+"?name="+encodeURIComponent(name),
              {method:"POST"});
  loadPresets();
}
async function loadPresets() {
  const names = await (await fetch("/api/presets")).json();
  const sel = el("preset"); sel.innerHTML="";
  for (const n of names) { const o=document.createElement("option");
    o.value=o.textContent=n; sel.appendChild(o); }
  sel.onchange = async () => {
    const r = await fetch("/api/preset/load?name="+
      encodeURIComponent(sel.value), {method:"POST"});
    S = (await r.json()).settings; reflect(); loadAxis();
  };
}

const canvas = el("c"), ctx2d = canvas.getContext("2d");
function drawFrame(h, w, bytes) {
  if (canvas.width !== w) { canvas.width = w; canvas.height = h; }
  ctx2d.putImageData(new ImageData(new Uint8ClampedArray(bytes), w, h), 0, 0);
}
async function streamLoop() {
  // push stream (chunked HTTP): frames arrive as they are painted,
  // no 66 ms polling cadence; auto-reconnects on drop
  try {
    const r = await fetch("/api/stream");
    const reader = r.body.getReader();
    let buf = new Uint8Array(0);
    while (true) {
      const {done, value} = await reader.read();
      if (done) break;
      const nb = new Uint8Array(buf.length + value.length);
      nb.set(buf); nb.set(value, buf.length); buf = nb;
      while (buf.length >= 8) {
        const dv = new DataView(buf.buffer, buf.byteOffset);
        const h = dv.getUint32(0), w = dv.getUint32(4);
        const need = 8 + h * w * 4;
        if (buf.length < need) break;
        drawFrame(h, w, buf.subarray(8, need));
        buf = buf.subarray(need);
      }
    }
  } catch (e) {}
  setTimeout(streamLoop, 1000);
}
async function stateLoop() {
  try {
    const st = await (await fetch("/api/state")).json();
    el("minimized").style.display = st.paused ? "flex" : "none";
    document.title = (S && S.on_top ? "📌 " : "") + "emspec";
    showUpdate(st.update);   // async check may land after page load
  } catch (e) {}
  setTimeout(stateLoop, 500);
}

canvas.addEventListener("mousemove", async (ev) => {
  const tip = el("tip");
  if (!ev.shiftKey) { tip.style.display="none"; return; }
  const rect = canvas.getBoundingClientRect();
  const frac = 1 - (ev.clientY - rect.top) / rect.height;
  const r = await fetch("/api/hover?frac="+frac.toFixed(4));
  tip.textContent = await r.text();
  tip.style.left = (ev.clientX+14)+"px"; tip.style.top = (ev.clientY+8)+"px";
  tip.style.display = "block";
});

(async () => {
  const meta = await (await fetch("/api/meta")).json();
  buildPanel(meta);
  S = await (await fetch("/api/settings")).json();
  reflect(); loadPresets(); loadAxis(); streamLoop(); stateLoop();
})();
</script>
</body>
</html>
"""
