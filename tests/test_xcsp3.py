from turbo_tpu.frontend.xcsp3 import parse_xcsp3
from turbo_tpu.compile.model import compile_model
from turbo_tpu.solver.oracle import solve


CUMULATIVE = """<instance format="XCSP3" type="COP">
<variables>
 <array id="s" size="[3]"> 0..6 </array>
 <var id="e"> 0..9 </var>
</variables>
<constraints>
 <cumulative>
  <origins> s[] </origins>
  <lengths> 2 3 2 </lengths>
  <heights> 2 1 2 </heights>
  <condition> (le,3) </condition>
 </cumulative>
 <intension> le(add(s[0],2),e) </intension>
 <intension> le(add(s[1],3),e) </intension>
 <intension> le(add(s[2],2),e) </intension>
</constraints>
<objectives><minimize> e </minimize></objectives>
</instance>"""


def test_cumulative_golden(tmp_path):
    # Tasks 0 and 2 (height 2 each) cannot overlap under capacity 3;
    # task 1 (height 1) runs beside either: the makespan is 2 + 2 = 4.
    p = tmp_path / "cumulative.xml"
    p.write_text(CUMULATIVE)
    m = parse_xcsp3(str(p))
    tnf = compile_model(m)
    r = solve(tnf, timeout_s=60)
    assert r.status == "optimal"
    assert r.objective == 4


def _solve_xml(tmp_path, xml, engine=False):
    p = tmp_path / "m.xml"
    p.write_text(xml)
    m = parse_xcsp3(str(p))
    tnf = compile_model(m)
    if engine:
        from turbo_tpu.solver.engine import BatchedSolver, EngineConfig
        return BatchedSolver(tnf, EngineConfig(
            num_dives=8, subproblems_power=4,
            max_depth=64)).solve(timeout_s=60), m, tnf
    return solve(tnf, timeout_s=60), m, tnf


def test_intension_arith(tmp_path):
    # x+y == 7, |x-y| == 1, x*y maximal -> {3,4}: obj x*y = 12
    xml = """<instance format="XCSP3" type="COP">
<variables>
 <var id="x"> 0..6 </var><var id="y"> 0..6 </var>
 <var id="p"> 0..36 </var>
</variables>
<constraints>
 <intension> eq(add(x,y),7) </intension>
 <intension> eq(dist(x,y),1) </intension>
 <intension> eq(mul(x,y),p) </intension>
</constraints>
<objectives><maximize> p </maximize></objectives>
</instance>"""
    r, _, _ = _solve_xml(tmp_path, xml)
    assert r.status == "optimal" and r.objective == 12


def test_intension_logic(tmp_path):
    # (x<3) or (y<2); x>=3 forced -> y<2; maximize x+y -> x=5,y=1
    xml = """<instance format="XCSP3" type="COP">
<variables>
 <var id="x"> 3..5 </var><var id="y"> 0..9 </var>
 <var id="s"> 0..20 </var>
</variables>
<constraints>
 <intension> or(lt(x,3),lt(y,2)) </intension>
 <intension> eq(add(x,y),s) </intension>
</constraints>
<objectives><maximize> s </maximize></objectives>
</instance>"""
    r, _, _ = _solve_xml(tmp_path, xml)
    assert r.status == "optimal" and r.objective == 6


def test_extension_supports(tmp_path):
    xml = """<instance format="XCSP3" type="CSP">
<variables>
 <array id="z" size="[2]"> 0..5 </array>
</variables>
<constraints>
 <extension>
  <list> z[] </list>
  <supports> (1,2)(3,4)(5,0) </supports>
 </extension>
 <intension> gt(z[0],3) </intension>
</constraints>
</instance>"""
    r, _, _ = _solve_xml(tmp_path, xml)
    assert r.status == "sat"
    assert int(r.best_lb[0]) == 5 and int(r.best_lb[1]) == 0


def test_extension_conflicts_and_unary(tmp_path):
    xml = """<instance format="XCSP3" type="CSP">
<variables>
 <var id="a"> 0..3 </var><var id="b"> 0..3 </var>
</variables>
<constraints>
 <extension><list> a </list><supports> (1)(3) </supports></extension>
 <extension>
  <list> a b </list>
  <conflicts> (1,0)(1,1)(1,2)(1,3)(3,0)(3,1)(3,2) </conflicts>
 </extension>
</constraints>
</instance>"""
    r, _, _ = _solve_xml(tmp_path, xml)
    assert r.status == "sat"
    assert int(r.best_lb[0]) == 3 and int(r.best_lb[1]) == 3


def test_element_and_group(tmp_path):
    xml = """<instance format="XCSP3" type="CSP">
<variables>
 <var id="i"> 0..2 </var><var id="v"> 0..40 </var>
 <array id="w" size="[3]"> 1..3 </array>
</variables>
<constraints>
 <element>
  <list startIndex="0"> 10 20 30 </list>
  <index> i </index>
  <value> v </value>
 </element>
 <group>
  <intension> eq(%0,%1) </intension>
  <args> w[0] 1 </args>
  <args> w[1] 2 </args>
  <args> w[2] 3 </args>
 </group>
 <element>
  <list startIndex="0"> w[] </list>
  <index> w[0] </index>
  <value> 2 </value>
 </element>
 <intension> ge(i,2) </intension>
</constraints>
</instance>"""
    r, _, _ = _solve_xml(tmp_path, xml)
    assert r.status == "sat"
    # v = [10,20,30][i] with i>=2 -> i=2, v=30; w=[1,2,3]; w[w[0]]=w[1]=2 ok
    assert int(r.best_lb[0]) == 2 and int(r.best_lb[1]) == 30


def test_minimum_maximum_instantiation(tmp_path):
    xml = """<instance format="XCSP3" type="CSP">
<variables>
 <array id="q" size="[3]"> 0..9 </array>
</variables>
<constraints>
 <instantiation><list> q[0] </list><values> 4 </values></instantiation>
 <minimum><list> q[] </list><condition> (eq,2) </condition></minimum>
 <maximum><list> q[] </list><condition> (le,6) </condition></maximum>
 <intension> lt(q[1],q[2]) </intension>
 <intension> eq(add(q[1],q[2]),8) </intension>
</constraints>
</instance>"""
    r, _, _ = _solve_xml(tmp_path, xml)
    assert r.status == "sat"
    vals = [int(r.best_lb[i]) for i in range(3)]
    assert vals[0] == 4 and min(vals) == 2 and max(vals) <= 6
    assert vals[1] < vals[2] and vals[1] + vals[2] == 8


def test_xcsp3_engine_differential(tmp_path):
    # The widened surface also runs through the batched engine.
    xml = """<instance format="XCSP3" type="COP">
<variables>
 <var id="x"> 0..6 </var><var id="y"> 0..6 </var>
 <var id="p"> 0..36 </var>
</variables>
<constraints>
 <intension> eq(add(x,y),7) </intension>
 <intension> eq(dist(x,y),1) </intension>
 <intension> eq(mul(x,y),p) </intension>
</constraints>
<objectives><maximize> p </maximize></objectives>
</instance>"""
    r, _, _ = _solve_xml(tmp_path, xml, engine=True)
    assert r.status == "optimal" and r.objective == 12


def test_objective_weighted_sum_and_maximum(tmp_path):
    xml = """<instance format="XCSP3" type="COP">
<variables>
 <var id="x"> 0..5 </var><var id="y"> 0..5 </var>
</variables>
<constraints>
 <intension> le(add(x,y),6) </intension>
</constraints>
<objectives>
 <maximize type="sum"><list> x y </list><coeffs> 2 3 </coeffs></maximize>
</objectives>
</instance>"""
    r, _, _ = _solve_xml(tmp_path, xml)
    # max 2x+3y s.t. x+y<=6, x,y in 0..5 -> x=1,y=5 -> 17
    assert r.status == "optimal" and r.objective == 17
    xml2 = """<instance format="XCSP3" type="COP">
<variables>
 <var id="a"> 1..9 </var><var id="b"> 2..7 </var>
</variables>
<constraints>
 <intension> eq(add(a,b),9) </intension>
</constraints>
<objectives>
 <minimize type="maximum"><list> a b </list></minimize>
</objectives>
</instance>"""
    r2, _, _ = _solve_xml(tmp_path, xml2)
    # minimize max(a,b) with a+b=9 -> {4,5} -> 5
    assert r2.status == "optimal" and r2.objective == 5


def test_extension_unary_plain_value_form(tmp_path):
    """XCSP3-core writes unary tables as plain values (no parens);
    previously this made supports wrongly UNSAT and silently dropped
    conflicts."""
    xml = """<instance format="XCSP3" type="CSP">
<variables><var id="x"> 0..9 </var></variables>
<constraints>
 <extension><list> x </list><supports> 1 4 7 </supports></extension>
 <intension> gt(x,4) </intension>
</constraints>
</instance>"""
    r, _, _ = _solve_xml(tmp_path, xml)
    assert r.status == "sat" and int(r.best_lb[0]) == 7
    xml2 = """<instance format="XCSP3" type="CSP">
<variables><var id="x"> 0..3 </var></variables>
<constraints>
 <extension><list> x </list><conflicts> 0 1 2 </conflicts></extension>
</constraints>
</instance>"""
    r2, _, _ = _solve_xml(tmp_path, xml2)
    assert r2.status == "sat" and int(r2.best_lb[0]) == 3


def test_extension_interval_compression(tmp_path):
    """(1..3,0) expands to (1,0)(2,0)(3,0)."""
    xml = """<instance format="XCSP3" type="CSP">
<variables>
 <var id="a"> 0..5 </var><var id="b"> 0..5 </var>
</variables>
<constraints>
 <extension><list> a b </list><supports> (1..3,0)(5,5) </supports></extension>
 <intension> ge(a,2) </intension>
 <intension> le(b,4) </intension>
</constraints>
</instance>"""
    r, _, _ = _solve_xml(tmp_path, xml)
    assert r.status == "sat"
    assert int(r.best_lb[0]) in (2, 3) and int(r.best_lb[1]) == 0


def test_sparse_domain_holes(tmp_path):
    # ADVICE r1 (high): a sparse domain "1 3 5" must exclude 2 and 4;
    # relaxing to the hull admitted sum(x)=2 -> wrong SAT.
    xml = """<instance format="XCSP3" type="CSP">
<variables>
 <var id="x"> 1 3 5 </var>
</variables>
<constraints>
 <intension> eq(x,2) </intension>
</constraints>
</instance>"""
    r, _, _ = _solve_xml(tmp_path, xml)
    assert r.status == "unsat"


def test_sparse_domain_optimum(tmp_path):
    # Minimizing over {2,5,9} with x>3 must give 5, not 4.
    xml = """<instance format="XCSP3" type="COP">
<variables>
 <var id="x"> 2 5 9 </var>
</variables>
<constraints>
 <intension> gt(x,3) </intension>
</constraints>
<objectives><minimize> x </minimize></objectives>
</instance>"""
    r, _, _ = _solve_xml(tmp_path, xml)
    assert r.status == "optimal" and r.objective == 5


def test_sparse_domain_array_and_range_mix(tmp_path):
    # Array domain with a range+values mix "0..2 7": 3..6 excluded.
    xml = """<instance format="XCSP3" type="COP">
<variables>
 <array id="a" size="[2]"> 0..2 7 </array>
</variables>
<constraints>
 <intension> gt(a[0],2) </intension>
 <intension> gt(a[1],a[0]) </intension>
</constraints>
<objectives><minimize> a[1] </minimize></objectives>
</instance>"""
    r, _, _ = _solve_xml(tmp_path, xml)
    # a[0] must be 7, a[1] > 7 impossible within {0,1,2,7} -> unsat
    assert r.status == "unsat"
