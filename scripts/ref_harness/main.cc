// Parity harness around the REFERENCE engine core.
//
// Compiles /root/reference/{kguts.cc,kmer_image.cc,kmer_encoder.cc,
// fasta_parser.cc} verbatim (with a ~50-line boost shim, see shim/) and
// drives KmerGuts over a data dir written by our builder (mem_map +
// function.index + otu.index).  Emits, per input sequence, the exact
// grammar of the reference's own formatters (kguts.cc:939-973) plus a
// BEST-CALL line from find_best_call (kguts.cc:1008-1199), so
// scripts/ref_parity.py can diff the byte stream against the JAX
// pipeline / oracle.
//
// Usage: ref_harness [--dna] [--no-hits] [--p:min_hits=3 ...] <data-dir>
//        (FASTA on stdin; one PROTEIN-ID/HIT*/CALL*/OTU-COUNTS/BEST-CALL///
//         block per sequence on stdout)
#include <boost/program_options.hpp>  // the shim, for a complete variables_map

#define DEFINE_GLOBALS
#include "global.h"

#include <iostream>
#include <map>
#include <memory>
#include <string>
#include <vector>

#include "fasta_parser.h"
#include "kguts.h"

int main(int argc, char **argv) {
    g_parameters = new boost::program_options::variables_map();

    std::string dir;
    bool dna = false, want_hits = true;
    std::map<std::string, std::string> params;
    for (int i = 1; i < argc; i++) {
        std::string a = argv[i];
        if (a == "--dna") {
            dna = true;
        } else if (a == "--no-hits") {
            want_hits = false;
        } else if (a.rfind("--p:", 0) == 0) {
            std::string kv = a.substr(4);
            auto eq = kv.find('=');
            if (eq == std::string::npos) {
                std::cerr << "bad param " << a << "\n";
                return 1;
            }
            params[kv.substr(0, eq)] = kv.substr(eq + 1);
        } else {
            dir = a;
        }
    }
    if (dir.empty()) {
        std::cerr << "Usage: " << argv[0]
                  << " [--dna] [--no-hits] [--p:name=val ...] data-dir\n";
        return 1;
    }

    auto image = std::make_shared<KmerImage>(dir);
    KmerGuts kg(dir, image);
    kg.set_parameters(params);

    FastaParser fp;
    fp.set_callback([&](const std::string &id, const std::string &seq) -> int {
        if (id.empty() && seq.empty())
            return 0;
        auto calls = std::make_shared<std::vector<KmerCall>>();
        auto otu = std::make_shared<KmerOtuStats>();
        std::cout << "PROTEIN-ID\t" << id << "\t" << seq.size() << "\n";
        std::function<void(KmerGuts::hit_in_sequence_t)> cb = nullptr;
        if (want_hits)
            cb = [&kg](KmerGuts::hit_in_sequence_t h) {
                std::cout << kg.format_hit(h);
            };
        if (dna)
            kg.process_seq(id.c_str(), seq.c_str(), calls, cb, otu);
        else
            kg.process_aa_seq(id, seq, calls, cb, otu);
        for (auto &c : *calls)
            std::cout << kg.format_call(c);
        std::cout << kg.format_otu_stats(id, seq.size(), *otu);
        int fi;
        std::string fn;
        float sc, wsc, off;
        kg.find_best_call(*calls, fi, fn, sc, wsc, off);
        std::cout << "BEST-CALL\t" << fi << "\t" << fn << "\t" << sc << "\t"
                  << wsc << "\t" << off << "\n";
        std::cout << "//\n";
        return 0;
    });
    fp.parse(std::cin);
    return 0;
}
