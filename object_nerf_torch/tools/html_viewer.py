"""Self-contained interactive 3D viewer: one HTML file, no dependencies.

Own copy of `object_nerf_tpu/tools/html_viewer.py` (numpy, base64, json):
the same layers, labels and title give the same file, byte for byte. The
reference's viewer is open3d's interactive window (tools/O3dVisualizer.py:
25-223: point clouds, cylinder lines, meshes, text_3d labels); here it is a
single offline HTML file with a hand-written WebGL renderer (no CDN fetches,
so it opens on an air-gapped workstation): orbit, pan and zoom, per-layer
visibility toggles, point size, 3D-anchored text labels, a ground-plane grid
and axes.

Geometry is embedded as base64 float32 buffers; a 100k-point scene is a
file of about 2 MB.
"""

from __future__ import annotations

import base64
import json
from pathlib import Path

import numpy as np


def _b64(arr: np.ndarray) -> str:
    return base64.b64encode(
        np.ascontiguousarray(arr, np.float32).tobytes()
    ).decode("ascii")


def write_html_viewer(path, layers, labels=None, title="object-nerf-tpu scene"):
    """Write a standalone interactive viewer.

    layers: list of dicts:
        {"name": str, "kind": "points"|"lines"|"mesh",
         "positions": (N,3) float32  (lines: consecutive endpoint pairs;
                                      mesh: triangle soup, 3 verts/tri),
         "colors": (N,3) float32 in [0,1] or None,
         "normals": (N,3) float32 (mesh only, optional)}
    labels: list of {"position": (3,), "text": str}.
    """
    payload = []
    for layer in layers:
        pos = np.asarray(layer["positions"], np.float32).reshape(-1, 3)
        colors = layer.get("colors")
        if colors is None:
            colors = np.tile(
                np.asarray(layer.get("color", (0.75, 0.75, 0.75)), np.float32),
                (len(pos), 1),
            )
        colors = np.asarray(colors, np.float32).reshape(-1, 3)
        entry = {
            "name": str(layer.get("name", layer["kind"])),
            "kind": layer["kind"],
            "pos": _b64(pos),
            "col": _b64(colors),
            "n": int(len(pos)),
        }
        if layer["kind"] == "mesh":
            normals = layer.get("normals")
            if normals is None:
                tri = pos.reshape(-1, 3, 3)
                fn = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
                fn /= np.maximum(np.linalg.norm(fn, axis=-1, keepdims=True),
                                 1e-12)
                normals = np.repeat(fn, 3, axis=0)
            entry["nrm"] = _b64(np.asarray(normals, np.float32).reshape(-1, 3))
        payload.append(entry)

    label_payload = [
        {"p": [float(x) for x in np.asarray(l["position"]).reshape(3)],
         "t": str(l["text"])}
        for l in (labels or [])
    ]

    all_pts = (
        np.concatenate(
            [np.asarray(l["positions"], np.float32).reshape(-1, 3)
             for l in layers]
        )
        if layers else np.zeros((1, 3), np.float32)
    )
    center = all_pts.mean(0)
    radius = float(max(1e-3, np.percentile(
        np.linalg.norm(all_pts - center, axis=-1), 95)))

    def js(obj):
        # '</script>' inside embedded strings would terminate the script
        # block; escape the slash (still valid JSON/JS)
        return json.dumps(obj).replace("</", "<\\/")

    import html as _html

    html = _TEMPLATE.replace("__TITLE__", _html.escape(title)) \
        .replace("__DATA__", js(payload)) \
        .replace("__LABELS__", js(label_payload)) \
        .replace("__CENTER__", js([float(c) for c in center])) \
        .replace("__RADIUS__", repr(radius))
    Path(path).write_text(html)
    return str(path)


_TEMPLATE = r"""<!doctype html>
<html><head><meta charset="utf-8"><title>__TITLE__</title><style>
 html,body{margin:0;height:100%;overflow:hidden;background:#101014;
   font:12px system-ui,sans-serif;color:#ddd}
 #c{width:100%;height:100%;display:block}
 #ui{position:absolute;top:8px;left:8px;background:rgba(16,16,20,.85);
   padding:8px 10px;border-radius:6px;max-width:240px}
 #ui label{display:block;margin:2px 0;cursor:pointer}
 #ui input[type=range]{width:110px;vertical-align:middle}
 .lbl{position:absolute;transform:translate(-50%,-120%);padding:1px 5px;
   background:rgba(0,0,0,.65);border-radius:3px;pointer-events:none;
   white-space:nowrap}
 #help{position:absolute;bottom:8px;left:8px;opacity:.6}
</style></head><body>
<canvas id="c"></canvas><div id="ui"><b>__TITLE__</b></div>
<div id="help">drag: orbit &nbsp; shift/right-drag: pan &nbsp; wheel: zoom</div>
<script>
"use strict";
const DATA=__DATA__, LABELS=__LABELS__, CENTER=__CENTER__, RADIUS=__RADIUS__;
function f32(b64){const s=atob(b64),a=new Uint8Array(s.length);
  for(let i=0;i<s.length;i++)a[i]=s.charCodeAt(i);return new Float32Array(a.buffer);}
const cv=document.getElementById("c"),gl=cv.getContext("webgl");
const VS=`attribute vec3 p;attribute vec3 c;attribute vec3 nr;
uniform mat4 mvp;uniform float ps;varying vec3 vc;varying vec3 vn;
void main(){gl_Position=mvp*vec4(p,1.);gl_PointSize=ps;vc=c;vn=nr;}`;
const FS=`precision mediump float;varying vec3 vc;varying vec3 vn;
uniform float lit;void main(){float l=lit>0.5?(.35+.65*abs(vn.z)):1.0;
gl_FragColor=vec4(vc*l,1.);}`;
function sh(t,src){const s=gl.createShader(t);gl.shaderSource(s,src);
  gl.compileShader(s);return s;}
const prog=gl.createProgram();
gl.attachShader(prog,sh(gl.VERTEX_SHADER,VS));
gl.attachShader(prog,sh(gl.FRAGMENT_SHADER,FS));gl.linkProgram(prog);
gl.useProgram(prog);
const A={p:gl.getAttribLocation(prog,"p"),c:gl.getAttribLocation(prog,"c"),
  nr:gl.getAttribLocation(prog,"nr")};
const U={mvp:gl.getUniformLocation(prog,"mvp"),
  ps:gl.getUniformLocation(prog,"ps"),lit:gl.getUniformLocation(prog,"lit")};
function buf(a){const b=gl.createBuffer();gl.bindBuffer(gl.ARRAY_BUFFER,b);
  gl.bufferData(gl.ARRAY_BUFFER,a,gl.STATIC_DRAW);return b;}
const layers=DATA.map(d=>({name:d.name,kind:d.kind,n:d.n,on:true,
  pb:buf(f32(d.pos)),cb:buf(f32(d.col)),
  nb:d.nrm?buf(f32(d.nrm)):null}));
// grid + axes layers
(function(){const g=[],gc=[],R=RADIUS*2,s=R/10;
 for(let i=-10;i<=10;i++){g.push(i*s,0,-R, i*s,0,R, -R,0,i*s, R,0,i*s);
   for(let k=0;k<4;k++)gc.push(.22,.22,.26);}
 const ax=[0,0,0,R*.5,0,0, 0,0,0,0,R*.5,0, 0,0,0,0,0,R*.5];
 const axc=[1,.3,.3,1,.3,.3, .3,1,.3,.3,1,.3, .3,.5,1,.3,.5,1];
 layers.push({name:"grid",kind:"lines",n:g.length/3,on:true,
   pb:buf(new Float32Array(g)),cb:buf(new Float32Array(gc)),nb:null});
 layers.push({name:"axes",kind:"lines",n:6,on:true,
   pb:buf(new Float32Array(ax)),cb:buf(new Float32Array(axc)),nb:null});})();
// matrices
function mul(a,b){const o=new Float32Array(16);
 for(let i=0;i<4;i++)for(let j=0;j<4;j++){let s=0;
  for(let k=0;k<4;k++)s+=a[k*4+j]*b[i*4+k];o[i*4+j]=s;}return o;}
function persp(fy,ar,n,f){const t=1/Math.tan(fy/2);return new Float32Array(
 [t/ar,0,0,0, 0,t,0,0, 0,0,(f+n)/(n-f),-1, 0,0,2*f*n/(n-f),0]);}
function lookAt(e,c,up){const z=norm3(sub(e,c)),x=norm3(cross(up,z)),
 y=cross(z,x);return new Float32Array([x[0],y[0],z[0],0, x[1],y[1],z[1],0,
 x[2],y[2],z[2],0, -dot(x,e),-dot(y,e),-dot(z,e),1]);}
function sub(a,b){return [a[0]-b[0],a[1]-b[1],a[2]-b[2]];}
function cross(a,b){return [a[1]*b[2]-a[2]*b[1],a[2]*b[0]-a[0]*b[2],
 a[0]*b[1]-a[1]*b[0]];}
function dot(a,b){return a[0]*b[0]+a[1]*b[1]+a[2]*b[2];}
function norm3(a){const l=Math.hypot(a[0],a[1],a[2])||1;
 return [a[0]/l,a[1]/l,a[2]/l];}
// orbit state
let theta=0.7,phi=1.1,dist=RADIUS*2.4,tgt=CENTER.slice(),psize=2.0;
const ui=document.getElementById("ui");
layers.forEach(l=>{const lab=document.createElement("label");
 const cb=document.createElement("input");cb.type="checkbox";cb.checked=true;
 cb.onchange=()=>{l.on=cb.checked;draw();};
 lab.appendChild(cb);lab.appendChild(document.createTextNode(
  ` ${l.name} (${l.kind}, ${l.n})`));ui.appendChild(lab);});
(function(){const lab=document.createElement("label");
 lab.appendChild(document.createTextNode("point size "));
 const r=document.createElement("input");r.type="range";
 r.min=1;r.max=8;r.step=0.5;r.value=psize;
 r.oninput=()=>{psize=+r.value;draw();};lab.appendChild(r);
 ui.appendChild(lab);})();
const lblDivs=LABELS.map(l=>{const d=document.createElement("div");
 d.className="lbl";d.textContent=l.t;document.body.appendChild(d);return d;});
let mvp=null;
function draw(){
 const w=cv.clientWidth,h=cv.clientHeight;
 if(cv.width!==w||cv.height!==h){cv.width=w;cv.height=h;}
 gl.viewport(0,0,w,h);gl.clearColor(0.063,0.063,0.078,1);
 gl.enable(gl.DEPTH_TEST);
 gl.clear(gl.COLOR_BUFFER_BIT|gl.DEPTH_BUFFER_BIT);
 const eye=[tgt[0]+dist*Math.sin(phi)*Math.cos(theta),
            tgt[1]+dist*Math.cos(phi),
            tgt[2]+dist*Math.sin(phi)*Math.sin(theta)];
 mvp=mul(persp(0.9,w/h,RADIUS*0.01,RADIUS*40),lookAt(eye,tgt,[0,1,0]));
 gl.uniformMatrix4fv(U.mvp,false,mvp);gl.uniform1f(U.ps,psize);
 for(const l of layers){if(!l.on)continue;
  gl.bindBuffer(gl.ARRAY_BUFFER,l.pb);
  gl.enableVertexAttribArray(A.p);gl.vertexAttribPointer(A.p,3,gl.FLOAT,false,0,0);
  gl.bindBuffer(gl.ARRAY_BUFFER,l.cb);
  gl.enableVertexAttribArray(A.c);gl.vertexAttribPointer(A.c,3,gl.FLOAT,false,0,0);
  if(l.nb){gl.uniform1f(U.lit,1);gl.bindBuffer(gl.ARRAY_BUFFER,l.nb);
   gl.enableVertexAttribArray(A.nr);gl.vertexAttribPointer(A.nr,3,gl.FLOAT,false,0,0);}
  else{gl.uniform1f(U.lit,0);gl.disableVertexAttribArray(A.nr);
   gl.vertexAttrib3f(A.nr,0,0,1);}
  gl.drawArrays(l.kind==="points"?gl.POINTS:
   l.kind==="lines"?gl.LINES:gl.TRIANGLES,0,l.n);}
 // project labels
 LABELS.forEach((l,i)=>{const p=l.p,
  x=mvp[0]*p[0]+mvp[4]*p[1]+mvp[8]*p[2]+mvp[12],
  y=mvp[1]*p[0]+mvp[5]*p[1]+mvp[9]*p[2]+mvp[13],
  wc=mvp[3]*p[0]+mvp[7]*p[1]+mvp[11]*p[2]+mvp[15];
  const d2=lblDivs[i];
  if(wc<=0){d2.style.display="none";return;}
  d2.style.display="block";
  d2.style.left=((x/wc*0.5+0.5)*cv.clientWidth)+"px";
  d2.style.top=((-y/wc*0.5+0.5)*cv.clientHeight)+"px";});
}
let drag=null;
cv.addEventListener("mousedown",e=>{drag={x:e.clientX,y:e.clientY,
 pan:e.shiftKey||e.button===2};});
window.addEventListener("mouseup",()=>drag=null);
window.addEventListener("mousemove",e=>{if(!drag)return;
 const dx=e.clientX-drag.x,dy=e.clientY-drag.y;drag.x=e.clientX;drag.y=e.clientY;
 if(drag.pan){const s=dist*0.0016;
  const fx=[Math.sin(theta-Math.PI/2),0,Math.cos(theta-Math.PI/2)];
  tgt[0]-=fx[0]*dx*s;tgt[2]-=fx[2]*dx*s;tgt[1]+=dy*s;}
 else{theta+=dx*0.008;phi=Math.min(3.1,Math.max(0.05,phi-dy*0.008));}
 draw();});
cv.addEventListener("wheel",e=>{e.preventDefault();
 dist*=Math.exp(e.deltaY*0.001);draw();},{passive:false});
cv.addEventListener("contextmenu",e=>e.preventDefault());
window.addEventListener("resize",draw);
draw();
</script></body></html>
"""
