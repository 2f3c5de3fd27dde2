"""The SASS walker of ``differt2d_tpu_torch.ops.sass_census`` on a
hand-written listing (no toolkit needed): loops, the common pass around a
slow path, short regions and forks, and the demangled names."""

from differt2d_tpu_torch.ops import sass_census as sc


def _listing(n_tail: int) -> str:
    """One loop (0x10 to the back edge): a square root whose slow path is a
    call, a short region with a reciprocal, then a branch over ``n_tail``
    additions."""
    end = 0xd0 + 16 * n_tail
    head = f"""
        Function : _Z6kernelv
        /*0000*/                   MOV R1, c[0x0][0x28] ;                 /* 0x0 */
        /*0010*/                   MUFU.RSQ R2, R3 ;                      /* 0x0 */
        /*0020*/                   FFMA R4, R2, R2, R3 ;
        /*0030*/               @!P0 BRA 0x70 ;
        /*0040*/                   MOV R5, R4 ;
        /*0050*/                   CALL.REL.NOINC 0x900 ;
        /*0060*/                   BRA 0x80 ;
        /*0070*/                   FMUL R6, R4, R4 ;
        /*0080*/               @P1 BRA 0xb0 ;
        /*0090*/                   FADD R7, R6, R6 ;
        /*00a0*/                   MUFU.RCP R8, R7 ;
        /*00b0*/                   FSETP.GT.AND P2, PT, R6, RZ, PT ;
        /*00c0*/               @P2 BRA {hex(end)} ;
"""
    body = "".join(f"        /*{0xd0 + 16 * i:04x}*/                   FADD R9, R9, R9 ;\n"
                   for i in range(n_tail))
    return head + body + f"        /*{end:04x}*/               @P3 BRA 0x10 ;\n"


def test_a_short_region_is_executed_and_a_slow_path_skipped():
    ins = sc.functions(_listing(18))["_Z6kernelv"]
    assert len(ins) == 13 + 18 + 1
    loops = sc.innermost_loops(ins)
    assert loops == [(1, 31)]
    (p,) = [sc.summary(q) for q in sc.passes(ins, *loops[0])]
    # 0x10-0x30, the jump over the call, 0x70-0xc0, 18 additions, back edge.
    assert p["total"] == 3 + 6 + 18 + 1
    assert p["slow_path_branches"] == 1 and p["calls"] == 0
    assert p["MUFU.RSQ"] == 1 and p["MUFU.RCP"] == 1 and p["sfu"] == 2
    assert p["fp32"] == 1 + 1 + 1 + 1 + 18


def test_a_long_region_forks_the_pass():
    ins = sc.functions(_listing(50))["_Z6kernelv"]
    (loop,) = sc.innermost_loops(ins)
    totals = sorted(sc.summary(q)["total"] for q in sc.passes(ins, *loop))
    assert totals == [3 + 6 + 1, 3 + 6 + 50 + 1]


def test_short_names_and_classes():
    gnu = "void (anonymous namespace)::opt_solver_kernel<1, 1, true, true>(float const*, int)"
    nv = "void <unnamed>::opt_solver_kernel<(int)1, (int)1, (bool)1, (bool)1>(const float *, int)"
    assert sc.short_name(gnu) == sc.short_name(nv) == "opt_solver_kernel<1, 1, true, true>"
    assert sc.klass("MUFU.RCP") == "sfu" and sc.klass("FFMA") == "fp32"
    assert sc.klass("LDS.128") == "memory" and sc.klass("BSSY") == "control"
    assert sc.opcode("@!P0 BRA 0x70") == "BRA" and sc.klass("IADD3") == "integer"


def _pass(total, **ops):
    return {"total": total, **ops}


def test_blocked_test_picks_the_sweep_and_counts_one_test():
    # A sequential value loop unrolled by 2 (seg_margin: two divisions a
    # test), and another loop with no division.
    seq = [[_pass(146, **{"MUFU.RCP": 4})], [_pass(20)]]
    full, rej = sc.blocked_test(seq, sc.divisions_of("power_map_kernel<false, 1, false>"))
    assert full["total"] == 73 and full["MUFU.RCP"] == 2 and full["tests_a_pass"] == 2
    assert rej is None
    # The sigmoid's reciprocals (one a MUFU.EX2) are not the test's.
    sig = [[_pass(248, **{"MUFU.RCP": 7, "MUFU.EX2": 4})]]
    full, _ = sc.blocked_test(sig, sc.divisions_of("power_map_kernel<true, 2, false>"))
    assert full["total"] == 248 and full["tests_a_pass"] == 1
    # The redesigned sweep's loop (a bit scan) wins over the sequential one:
    # its longest pass is a full test, its shortest a rejected one.
    fast = [[_pass(94, **{"FLO.U32.SH": 1, "MUFU.RCP": 2}), _pass(45, **{"FLO.U32.SH": 1})]]
    full, rej = sc.blocked_test(seq + fast, 2)
    assert (full["total"], rej["total"]) == (94, 45)
    assert sc.blocked_test([[_pass(20)]], 2) == (None, None)
    assert sc.divisions_of("power_map_kernel<true, 1, true>") == 3
    assert sc.divisions_of("power_map_kernel<true, 0, false>") == 2
