"""HTML pages of the service (port of ``vfp_tpu/serve/templates.py``), the
same bytes as the JAX package's jinja2 rendering.

The pages are static: ``render_page`` fills a shared layout's title, head
and body from the constants below, so the standard library's
``string.Template`` renders them and the port needs no jinja2.  What the
pages do: a layout with Upload / View / Detect / History links; the upload
form posting multipart to ``/upload``; the hls.js player page, whose
transport rewrites every ``.m4s`` request to ``/hls/<basename>`` and every
``master.m3u8`` request to ``/view/<view_id>``, with bounded retries,
media-error recovery, the native-HLS fallback, the per-segment pattern
display and the per-view download button; and the detect page, which
HTML-escapes every untrusted field of a match (usernames are chosen by
whoever starts a view).
"""

from string import Template

_BASE = Template("""<!doctype html>
<html>
<head>
<meta charset="utf-8">
<title>$title — vfp-tpu</title>
$head
<style>
body{font-family:Arial,Helvetica,sans-serif;margin:0;min-height:100vh;
     display:flex;flex-direction:column;background:#eef1f4}
main{flex:1;width:100%;max-width:800px;margin:0 auto;box-sizing:border-box;padding:20px}
.card{background:#fff;padding:20px;border-radius:8px;box-shadow:0 2px 4px rgba(0,0,0,.1)}
button{padding:10px 20px;background:#007bff;color:#fff;border:none;border-radius:4px;
       cursor:pointer;font-size:16px}
button:hover{background:#0056b3}
input[type=text],input[type=number],input[type=file]{padding:8px;border:1px solid #ddd;
       border-radius:4px}
.error{display:none;color:#dc3545;background:#f8d7da;padding:10px;border-radius:4px;
       margin-bottom:20px}
.pattern{font-family:monospace;font-size:17px;background:#f1f3f5;padding:5px 10px;
         border-radius:3px;display:inline-block}
.panel{display:none;background:#f8f9fa;border:1px solid #dee2e6;border-radius:4px;
       padding:15px;margin:20px 0}
.seg{background:#fff;border:1px solid #eee;border-radius:4px;padding:10px;margin:10px 0}
.seg b{color:#495057}
footer{background:#f8f9fa;border-top:1px solid #dee2e6;padding:20px}
footer div{max-width:800px;margin:0 auto;display:flex;justify-content:center;gap:20px}
footer a{color:#6c757d;text-decoration:none;font-size:14px}
footer a:hover{color:#0056b3}
video{width:100%;max-height:600px;background:#000;display:none}
</style>
</head>
<body>
<main>$body</main>
<footer><div>
<a href="/upload">Upload</a><a href="/view">View</a><a href="/detect">Detect</a>
<a href="/view-history">History</a>
</div></footer>
</body>
</html>""")

_HLS_CDN = '<script src="https://cdn.jsdelivr.net/npm/hls.js@latest"></script>'

_UPLOAD_BODY = """<div class="card">
<h1>Upload Video</h1>
<div id="error" class="error"></div>
<form id="f">
  <p><label>Select Video File:<br><input type="file" name="file" accept="video/*" required></label></p>
  <p><label>Number of Copies:<br><input type="number" name="copies" value="3" min="1" max="10"></label></p>
  <button type="submit">Upload and Process</button>
</form>
<pre id="out"></pre>
</div>
<script>
document.getElementById('f').onsubmit = async (e) => {
  e.preventDefault();
  const out = document.getElementById('out');
  out.textContent = 'processing\\u2026';
  try {
    const r = await fetch('/upload', {method: 'POST',
                                      body: new FormData(e.target)});
    const j = await r.json();
    out.textContent = JSON.stringify(j, null, 2);
    if (!j.error && !j.detail) window.location.href = '/view';
  } catch (err) {
    const ed = document.getElementById('error');
    ed.textContent = 'Upload failed: ' + err.message;
    ed.style.display = 'block';
    out.textContent = '';
  }
};
</script>"""

# The player page.  The xhrSetup rewrite is the load-bearing part
# (reference: index.html:152-166): hls.js resolves segment URIs relative to
# the playlist URL, so without the rewrite a playlist served from
# /view/<id> would fetch /view/seg.m4s; the transport layer redirects
# *.m4s to /hls/ and master-playlist refetches back through /view/<id>.
_VIEW_BODY = """<div class="card">
<h1>Video Watermarking Viewer</h1>
<div id="error" class="error"></div>
<div class="video-container">
  <video id="videoPlayer" controls>
    <source id="videoSource" type="application/x-mpegURL">
  </video>
  <div id="videoPlaceholder" style="text-align:center;padding:20px;background:#f8f9fa;border-radius:4px">
    Enter your username and click &quot;Start View&quot; to begin watching
  </div>
</div>
<div id="watermarkInfo" class="panel">
  <h2>Your Watermark Patterns</h2>
  <p>Each pattern is unique to your viewing session and is embedded in
     different segments of the video.</p>
  <div id="watermarkPatterns"></div>
</div>
<p>
  <input type="text" id="username" placeholder="Enter your username" required>
  <button onclick="startView()">Start View</button>
  <button id="downloadBtn" onclick="downloadVideo()"
          style="display:none;background:#28a745">Download Video</button>
</p>
</div>
<script>
let hls = null;
let currentViewId = '';

function showError(message) {
  const e = document.getElementById('error');
  e.textContent = message;
  e.style.display = 'block';
  document.getElementById('watermarkInfo').style.display = 'none';
}

function initializeVideoPlayer() {
  const video = document.getElementById('videoPlayer');
  const source = document.getElementById('videoSource');
  video.style.display = 'block';
  document.getElementById('videoPlaceholder').style.display = 'none';
  const sourceUrl = '/view/' + currentViewId;

  if (window.Hls && Hls.isSupported()) {
    if (hls) hls.destroy();
    hls = new Hls({
      maxLoadingRetry: 3,
      manifestLoadingMaxRetry: 2, fragLoadingMaxRetry: 2, levelLoadingMaxRetry: 2,
      fragLoadingRetryDelay: 500, manifestLoadingRetryDelay: 500, levelLoadingRetryDelay: 500,
      fragLoadingMaxRetryTimeout: 2000, manifestLoadingMaxRetryTimeout: 2000,
      levelLoadingMaxRetryTimeout: 2000,
      xhrSetup: function (xhr, url) {
        // reroute segment fetches to /hls/ and playlist refetches to the
        // per-view route (reference: index.html:152-166)
        if (url.endsWith('.m4s')) {
          xhr.open('GET', '/hls/' + url.split('/').pop(), true);
        } else if (url.includes('master.m3u8')) {
          xhr.open('GET', '/view/' + currentViewId, true);
        }
      }
    });
    source.src = sourceUrl;
    hls.loadSource(sourceUrl);
    hls.attachMedia(video);

    let errorCount = 0;
    hls.on(Hls.Events.MANIFEST_PARSED, function () {
      video.play().catch(function (err) {
        showError('Error playing video: ' + err.message);
      });
    });
    hls.on(Hls.Events.ERROR, function (event, data) {
      errorCount++;
      if (data.fatal || errorCount >= 3) {
        hls.destroy();
        if (data.type === Hls.ErrorTypes.NETWORK_ERROR) {
          showError('Network error: Unable to load video segments. Please try again.');
        } else if (data.type === Hls.ErrorTypes.MEDIA_ERROR) {
          showError('Media error: Video format not supported or corrupted.');
        } else {
          showError('Fatal error: Unable to play video. Please try again.');
        }
      } else if (data.type === Hls.ErrorTypes.MEDIA_ERROR) {
        hls.recoverMediaError();
      } else if (data.type === Hls.ErrorTypes.NETWORK_ERROR) {
        hls.startLoad();
      }
    });
  } else if (video.canPlayType('application/vnd.apple.mpegurl')) {
    // Safari-style native HLS (reference: index.html:219-238)
    source.src = sourceUrl;
    video.src = sourceUrl;
    video.addEventListener('loadedmetadata', function () {
      video.play().catch(function (err) {
        showError('Error playing video: ' + err.message);
      });
    });
    video.addEventListener('error', function () {
      showError('Error playing video: Unable to load video segments.');
    });
  } else {
    showError('Your browser does not support HLS video playback');
  }
}

function displayWatermarkPatterns(patterns) {
  const container = document.getElementById('watermarkPatterns');
  container.innerHTML = '';
  Object.entries(patterns)
    .sort(([a], [b]) => parseInt(a.match(/\\d+/)[0]) - parseInt(b.match(/\\d+/)[0]))
    .forEach(([segment, info]) => {
      const div = document.createElement('div');
      div.className = 'seg';
      const segNo = segment.match(/\\d+/)[0];
      const copyM = segment.match(/copy(\\d+)/);
      div.innerHTML = '<b>Segment ' + segNo + '</b>' +
        (copyM ? ' <span>Copy ' + copyM[1] + '</span>' : '') +
        '<br><span class="pattern">' + info.payload.join('') + '</span>';
      container.appendChild(div);
    });
}

async function startView() {
  const username = document.getElementById('username').value;
  if (!username) { showError('Please enter a username'); return; }
  try {
    const r = await fetch('/start-view', {
      method: 'POST',
      headers: {'Content-Type': 'application/json'},
      body: JSON.stringify({username: username})
    });
    const data = await r.json();
    if (data.status === 'success') {
      currentViewId = data.view_id;
      displayWatermarkPatterns(data.segment_patterns);
      document.getElementById('watermarkInfo').style.display = 'block';
      document.getElementById('error').style.display = 'none';
      document.getElementById('downloadBtn').style.display = 'inline-block';
      initializeVideoPlayer();
    } else {
      showError(data.error || data.detail || 'Failed to start view');
    }
  } catch (err) {
    showError('Error starting view: ' + err.message);
  }
}

function downloadVideo() {
  if (!currentViewId) { showError('Please start a view before downloading'); return; }
  window.location.href = '/download-view/' + currentViewId;
}
</script>"""

_DETECT_BODY = """<div class="card">
<h1>Detect Video Watermark</h1>
<p>Upload a video segment to detect its watermark and identify the source.</p>
<form id="detectForm">
  <p><label>Select Video Segment:<br>
     <input type="file" id="file" name="file" accept="video/*" required></label></p>
  <button type="submit">Detect Watermark</button>
</form>
<div id="results" class="panel"><h3>Detection Results</h3>
  <div id="resultsContent"></div>
</div>
</div>
<script>
// usernames are attacker-chosen at /start-view; detect results must be
// HTML-escaped before innerHTML or a leaked username executes script in the
// investigator's browser (the reference template has this flaw; we don't)
const esc = s => String(s).replace(/[&<>"']/g,
  c => ({'&': '&amp;', '<': '&lt;', '>': '&gt;', '"': '&quot;', "'": '&#39;'}[c]));
document.getElementById('detectForm').addEventListener('submit', async function (e) {
  e.preventDefault();
  const results = document.getElementById('results');
  const content = document.getElementById('resultsContent');
  results.style.display = 'block';
  content.textContent = 'detecting\\u2026';
  try {
    const fd = new FormData();
    fd.append('file', document.getElementById('file').files[0]);
    const r = await fetch('/detect', {method: 'POST', body: fd});
    const data = await r.json();
    if (data.error) {
      content.innerHTML = '<div class="error" style="display:block">' + esc(data.error) + '</div>';
      return;
    }
    if (data.status === 'success') {
      // per-match card (reference: detect.html:119-137)
      content.innerHTML = data.matches.map(m =>
        '<div class="seg">' +
        '<p><b>Username:</b> ' + esc(m.username) + '</p>' +
        '<p><b>Timestamp:</b> ' + esc(new Date(m.timestamp).toLocaleString()) + '</p>' +
        '<p><b>Pattern:</b> <span class="pattern">' + esc(m.payload.join('')) + '</span></p>' +
        '<p><b>Segment Number:</b> ' + esc(m.segment_number) + '</p>' +
        '<p><b>Confidence:</b> ' + esc((m.frequency * 100).toFixed(1)) + '%</p>' +
        '</div>').join('');
    } else {
      content.innerHTML = '<div class="error" style="display:block">No matches found.<br>' +
                          esc(data.note || '') + '</div>';
    }
  } catch (err) {
    content.innerHTML = '<div class="error" style="display:block">' +
                        'An error occurred while detecting the watermark.</div>';
  }
});
</script>"""

_PAGES = {
    "upload": ("Upload Video", "", _UPLOAD_BODY),
    "view": ("Video Watermarking Viewer", _HLS_CDN, _VIEW_BODY),
    "detect": ("Detect Watermark", "", _DETECT_BODY),
}


def render_page(name: str) -> str:
    title, head, body = _PAGES[name]
    return _BASE.substitute(title=title, head=head, body=body)
