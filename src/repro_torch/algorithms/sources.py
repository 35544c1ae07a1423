"""Graphitron DSL sources for the paper's evaluation algorithms.

BFS follows paper Fig. 1 (top-down, ECP) and Fig. 2 (direction-switching
hybrid). SSSP is the Fig. 5 program — the compiler performs the Fig. 6 RAW
decoupling automatically. PPR and CGAW follow Algorithms 1 and 2. WCC and
k-core are beyond-paper additions demonstrating expressiveness.
"""

# --------------------------------------------------------------------------
# BFS — paper Fig. 1 (top-down, edge-centric)
# --------------------------------------------------------------------------
BFS_ECP = r"""
element Vertex end
element Edge end
const edges: edgeset{Edge}(Vertex, Vertex) = load(argv[1]);
const vertices: vertexset{Vertex} = edges.getVertices();
const old_level: vector{Vertex}(int);
const new_level: vector{Vertex}(int);
const tuple: vector{Vertex}(int);
const level: int = 1;
const activeVertex: vector{Vertex}(int);
const root: int = 0;

func reset(v: Vertex)
    old_level[v] = -1;
    new_level[v] = -1;
    tuple[v] = 2147483647;
end
func EdgeTraversal(src: Vertex, dst: Vertex)
    if (old_level[src] == level)
        tuple[dst] min= level + 1;
    end
end
func VertexUpdate(v: Vertex)
    if ((tuple[v] == (level + 1)) & (old_level[v] == -1))
        new_level[v] = tuple[v];
        activeVertex[0] = activeVertex[0] + 1;
    end
end
func VertexApply(v: Vertex)
    old_level[v] = new_level[v];
end
func main()
    vertices.init(reset);  % Initialization
    old_level[root] = 1;
    new_level[root] = 1;
    var frontier_size: int = 1;
    while (frontier_size)
        edges.process(EdgeTraversal);
        vertices.process(VertexUpdate);
        vertices.process(VertexApply);
        frontier_size = activeVertex[0];
        activeVertex[0] = 0;
        level += 1;
    end
end
"""

# --------------------------------------------------------------------------
# BFS — paper Fig. 2 (direction-switching hybrid VCP/ECP)
# --------------------------------------------------------------------------
BFS_HYBRID = r"""
element Vertex end
element Edge end
const edges: edgeset{Edge}(Vertex, Vertex) = load(argv[1]);
const vertices: vertexset{Vertex} = edges.getVertices();
const old_level: vector{Vertex}(int);
const new_level: vector{Vertex}(int);
const tuple: vector{Vertex}(int);
const level: int = 1;
const activeVertex: vector{Vertex}(int);
const root: int = 0;

func reset(v: Vertex)
    old_level[v] = -1;
    new_level[v] = -1;
    tuple[v] = 2147483647;
end
func EdgeTraversal(src: Vertex, dst: Vertex)
    if (old_level[src] == level)
        tuple[dst] min= level + 1;
    end
end
func VertexTraversal(v: Vertex)
    if (old_level[v] == level)
        for ngh in v.getNeighbors()
            tuple[ngh] min= level + 1;
        end
    end
end
func VertexUpdate(v: Vertex)
    if ((tuple[v] == (level + 1)) & (old_level[v] == -1))
        new_level[v] = tuple[v];
        activeVertex[0] = activeVertex[0] + 1;
    end
end
func VertexApply(v: Vertex)
    old_level[v] = new_level[v];
end
func main()
    vertices.init(reset);
    old_level[root] = 1;
    new_level[root] = 1;
    var frontier_size: int = 1;
    while (frontier_size)
        if (frontier_size < 0.05 * vertices.size())
            vertices.process(VertexTraversal);
        else
            edges.process(EdgeTraversal);
        end
        vertices.process(VertexUpdate);
        vertices.process(VertexApply);
        frontier_size = activeVertex[0];
        activeVertex[0] = 0;
        level += 1;
    end
end
"""

# --------------------------------------------------------------------------
# PageRank (edge-centric, fixed iterations)
# --------------------------------------------------------------------------
PAGERANK = r"""
element Vertex end
element Edge end
const edges: edgeset{Edge}(Vertex, Vertex) = load(argv[1]);
const vertices: vertexset{Vertex} = edges.getVertices();
const rank: vector{Vertex}(float);
const contrib: vector{Vertex}(float);
const deg: vector{Vertex}(int) = edges.getOutDegrees();
const damp: float = 0.85;
const iters: int = 20;

func initRank(v: Vertex)
    rank[v] = 1.0 / to_float(vertices.size());
    contrib[v] = 0.0;
end
func computeContrib(src: Vertex, dst: Vertex)
    if (deg[src] > 0)
        contrib[dst] += rank[src] / to_float(deg[src]);
    end
end
func applyRank(v: Vertex)
    rank[v] = (1.0 - damp) / to_float(vertices.size()) + damp * contrib[v];
    contrib[v] = 0.0;
end
func main()
    vertices.init(initRank);
    var i: int = 0;
    while (i < iters)
        edges.process(computeContrib);
        vertices.process(applyRank);
        i = i + 1;
    end
end
"""

# --------------------------------------------------------------------------
# SSSP — paper Fig. 5 form; the compiler applies the Fig. 6 decoupling
# --------------------------------------------------------------------------
SSSP = r"""
element Vertex end
element Edge end
const edges: edgeset{Edge}(Vertex, Vertex, int) = load(argv[1]);
const vertices: vertexset{Vertex} = edges.getVertices();
const SP: vector{Vertex}(int);
const tuple: vector{Vertex}(int);
const active: vector{Vertex}(int);
const activeNext: vector{Vertex}(int);
const changed: vector{Vertex}(int);
const root: int = 0;
const INF: int = 1073741823;

func initSP(v: Vertex)
    SP[v] = INF;
    tuple[v] = INF;
    active[v] = 0;
    activeNext[v] = 0;
end
func relax(src: Vertex, dst: Vertex, weight: int)
    if (active[src] == 1)
        tuple[dst] min= (SP[src] + weight);
    end
end
func update(v: Vertex)
    if (tuple[v] < SP[v])
        SP[v] = tuple[v];
        activeNext[v] = 1;
        changed[0] = changed[0] + 1;
    end
end
func advance(v: Vertex)
    active[v] = activeNext[v];
    activeNext[v] = 0;
end
func main()
    vertices.init(initSP);
    SP[root] = 0;
    active[root] = 1;
    var n_changed: int = 1;
    while (n_changed)
        changed[0] = 0;
        edges.process(relax);
        vertices.process(update);
        vertices.process(advance);
        n_changed = changed[0];
    end
end
"""

# --------------------------------------------------------------------------
# PPR — paper Algorithm 1 (personalized PageRank with convergence count)
# --------------------------------------------------------------------------
PPR = r"""
element Vertex end
element Edge end
const edges: edgeset{Edge}(Vertex, Vertex) = load(argv[1]);
const vertices: vertexset{Vertex} = edges.getVertices();
const PR_old: vector{Vertex}(float);
const PR_new: vector{Vertex}(float);
const contrib: vector{Vertex}(float);
const map: vector{Vertex}(float);
const conv: vector{Vertex}(int);
const deg: vector{Vertex}(int) = edges.getOutDegrees();
const m: float = 0.85;
const eps: float = 0.001;
const source: int = 0;
const max_iters: int = 100;

func initPPR(v: Vertex)
    PR_old[v] = 0.0;
    PR_new[v] = 0.0;
    contrib[v] = 0.0;
    map[v] = 0.0;
end
func spread(src: Vertex, dst: Vertex)
    if (deg[src] > 0)
        contrib[dst] += PR_old[src] / to_float(deg[src]);
    end
end
func applyPPR(v: Vertex)
    PR_new[v] = (1.0 - m) * map[v] + m * contrib[v];
    if (abs(PR_new[v] - PR_old[v]) < eps)
        conv[0] = conv[0] + 1;
    end
    contrib[v] = 0.0;
end
func main()
    vertices.init(initPPR);
    map[source] = 1.0;
    PR_old[source] = 1.0;
    var done: int = 0;
    var it: int = 0;
    while ((done < vertices.size()) & (it < max_iters))
        conv[0] = 0;
        edges.process(spread);
        vertices.process(applyPPR);
        swap(PR_new, PR_old);
        done = conv[0];
        it = it + 1;
    end
end
"""

# --------------------------------------------------------------------------
# CGAW — paper Algorithm 2 (graph attention weights; writes edge weights)
# --------------------------------------------------------------------------
CGAW = r"""
element Vertex end
element Edge end
const edges: edgeset{Edge}(Vertex, Vertex, float) = load(argv[1]);
const vertices: vertexset{Vertex} = edges.getVertices();
const feat: vector{Vertex}(float);
const expsum: vector{Vertex}(float);

func initFeat(v: Vertex)
    feat[v] = sigmoid(to_float(original_id(v)) * 0.001 - 1.0);
    expsum[v] = 0.0;
end
func score(src: Vertex, dst: Vertex, weight: float)
    weight = leakyrelu(feat[src] + feat[dst], 0.2);
    expsum[dst] += exp(weight);
end
func normalize(src: Vertex, dst: Vertex, weight: float)
    weight = exp(weight) / expsum[dst];
end
func main()
    vertices.init(initFeat);
    edges.process(score);
    edges.process(normalize);
end
"""

# --------------------------------------------------------------------------
# WCC — label propagation (beyond paper; exercises src-side scatter)
# --------------------------------------------------------------------------
WCC = r"""
element Vertex end
element Edge end
const edges: edgeset{Edge}(Vertex, Vertex) = load(argv[1]);
const vertices: vertexset{Vertex} = edges.getVertices();
const comp: vector{Vertex}(int);
const comp_next: vector{Vertex}(int);
const changed: vector{Vertex}(int);

func initComp(v: Vertex)
    comp[v] = v;
    comp_next[v] = v;
end
func propagate(src: Vertex, dst: Vertex)
    comp_next[dst] min= comp[src];
    comp_next[src] min= comp[dst];
end
func applyComp(v: Vertex)
    if (comp_next[v] < comp[v])
        comp[v] = comp_next[v];
        changed[0] = changed[0] + 1;
    end
end
func main()
    vertices.init(initComp);
    var n_changed: int = 1;
    while (n_changed)
        changed[0] = 0;
        edges.process(propagate);
        vertices.process(applyComp);
        n_changed = changed[0];
    end
end
"""

# --------------------------------------------------------------------------
# k-core — iterative peeling (beyond paper)
# --------------------------------------------------------------------------
KCORE = r"""
element Vertex end
element Edge end
const edges: edgeset{Edge}(Vertex, Vertex) = load(argv[1]);
const vertices: vertexset{Vertex} = edges.getVertices();
const alive: vector{Vertex}(int);
const degc: vector{Vertex}(int);
const removed: vector{Vertex}(int);
const k: int = 2;

func initAlive(v: Vertex)
    alive[v] = 1;
end
func resetDeg(v: Vertex)
    degc[v] = 0;
end
func countDeg(src: Vertex, dst: Vertex)
    if ((alive[src] == 1) & (alive[dst] == 1))
        degc[src] = degc[src] + 1;
        degc[dst] = degc[dst] + 1;
    end
end
func peel(v: Vertex)
    if ((alive[v] == 1) & (degc[v] < k))
        alive[v] = 0;
        removed[0] = removed[0] + 1;
    end
end
func main()
    vertices.init(initAlive);
    var n_removed: int = 1;
    while (n_removed)
        removed[0] = 0;
        vertices.process(resetDeg);
        edges.process(countDeg);
        vertices.process(peel);
        n_removed = removed[0];
    end
end
"""
